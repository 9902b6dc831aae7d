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
//   groupsort.cu group_words does for K5) and writes one word a row: the
//   fast branch's acc = clip(key - min, 0, rng - 1), rng for an invalid
//   row; else the key, INT64_MAX for an invalid row.  K10's radix sort
//   (sort.cu, called through its C entry) orders that word with the row
//   index as the tie-break and writes the sorted word itself; one
//   elementwise epilogue turns the fast branch's acc_s back into keys
//   (INT64_MAX where acc_s >= rng).  Bound: bytes; the sort's active
//   passes (three for TPC-H's dense keys) dominate.
// - Probe (K7): the reference's two strategies, chosen on the device: a
//   direct-address table over [min, min + T), T = max(2 nb, np), when
//   the live keys span less than T (uint64 span), else a search.  Bound:
//   bytes (the sorted and probe keys read, lo and count written); what
//   costs is the table and the random reads.  Two launches, no atomics,
//   no initialisation:
//   - fill: the keys are sorted, so the row that starts a run is its
//     slot's only writer (one int32 a slot, the run's first row: 4T
//     bytes, 24 MB at T = 6 M, inside L2; int64 from 2^31 build rows
//     on); the row that ends the live prefix writes the branch record,
//     so neither a one-thread launch nor a search in every block (three
//     synchronised rounds before any row) finds it; every gap-th row
//     writes one of 1024 splitter keys;
//   - probe: each block reads the branch record once; direct, one slot
//     read, the slot's row checked against the key (a slot no run wrote
//     holds garbage that fails the check: no build row carries that key;
//     compute-sanitizer's initcheck would report the read by design), the
//     count by galloping from the run's first row (one read of its own
//     line for TPC-H's short runs); search, only in a block that holds a
//     valid probe row (the cluster programs' padded probes are mostly
//     invalid), the splitters copied into shared memory bracket the lower
//     bound, a binary search over one gap, and the same gallop.
//   This form was measured on the card against three others on Q5's
//   calls and kept as the fastest: a memset of the table first (-1 slots
//   skip the key read of a miss), (first row, count) pairs (no gallop,
//   twice the table), and both; see PERF.md.
// - Expansion (K8): one launch after one memset of its control words.
//   Tiles of 4096 probe rows take tickets (lookback.cuh); a tile reads
//   its pair counts (count, or max(count, 1) for valid probe rows of a
//   left outer join) with 16-byte loads, scans them in registers and
//   keeps the inclusive prefix in shared memory, chains its total to
//   the tiles before it by the decoupled look-back, then writes its own
//   pairs: the block's threads stride over the tile's output range,
//   eight slots a thread a step with their loads in flight together,
//   each finding its probe row in the shared prefix (one read while the
//   row repeats, else a binary search of the rows after it), so
//   adjacent threads store adjacent slots and a probe row with many
//   matches is spread over the whole block.  The
//   last tile writes the total and publishes it to padding blocks that
//   take tickets after every tile and write (0, 0) from the total (or
//   out_size) on: every slot is written once, no memset of the outputs,
//   no offsets in device memory.  Bound: bytes (the counts and, for a
//   left outer join, probe_valid read once; lo and perm read for the
//   rows and pairs that have them; 16 bytes a slot written).
// - Compose (K9): one launch gathers every prior index vector of a join
//   side and its output-space null masks at `take` (two rows a thread,
//   take read once); the prior reads are random, so they bound it, and
//   the launch, not the bytes, is most of a small call.  The masks are
//   one elementwise pass, 16 rows a thread with 16-byte loads and
//   stores.
#include "common.cuh"
#include "lookback.cuh"

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

// The end of the run of `key` that holds sk[lo]: gallop forward (lo + 1,
// + 2, + 4, ...; a short run is one read of lo's own cache line), then a
// binary search inside the last step.
__device__ __forceinline__ long long run_end(const long long* __restrict__ sk,
                                             long long nb, long long lo,
                                             long long key) {
  long long in = lo, out = nb, step = 1;
  while (in + step < nb) {
    if (sk[in + step] != key) {
      out = in + step;
      break;
    }
    in += step;
    step <<= 1;
  }
  long long a = in + 1;
  while (a < out) {
    const long long mid = a + (out - a) / 2;
    if (sk[mid] == key) a = mid + 1; else out = mid;
  }
  return a;
}

constexpr int kSplitters = 1024;   // search branch: sampled build keys

// The scratch of one call: the branch record (the reference's test and
// the least key), the splitters (every gap-th sorted key), the T slots.
struct ProbeHead {
  longlong2 gate;                 // {1 when the direct table applies, min}
  long long spl[kSplitters];
};

// The direct table without atomics: the keys are sorted, so the row that
// starts a run is the only writer of its key's slot (every run whose key
// lies in [min, min + T): all of them on the direct branch, a few or none
// on the search branch, which reads no slot).  The row that ends the live
// prefix (keys != INT64_MAX come first) writes the branch record from the
// live keys' uint64 span, row 0 when no key is live; every gap-th row
// writes its splitter.  One writer each: no atomics, no initialisation.
template <typename Slot>
__global__ void probe_fill(const long long* __restrict__ sk, long long nb,
                           long long T, ProbeHead* __restrict__ head,
                           Slot* __restrict__ tab) {
  const long long mn = sk[0];
  const long long gap = (nb + kSplitters - 1) / kSplitters;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nb; i += stride) {
    const long long k = sk[i];
    if (i % gap == 0) head->spl[i / gap] = k;
    if (k == kI64Max) {
      if (i == 0) head->gate = make_longlong2(0, mn);
      continue;
    }
    if (i + 1 == nb || sk[i + 1] == kI64Max)
      head->gate = make_longlong2((u64)k - (u64)mn < (u64)T, mn);
    if (i > 0 && sk[i - 1] == k) continue;
    const u64 off = (u64)k - (u64)mn;
    if (off < (u64)T) tab[off] = (Slot)i;
  }
}

template <typename Slot>
__global__ void probe_kernel(const long long* __restrict__ sk, long long nb,
                             const long long* __restrict__ probe,
                             const bool* __restrict__ probe_valid,
                             long long np, long long T,
                             const ProbeHead* __restrict__ head,
                             const Slot* __restrict__ tab,
                             long long* __restrict__ lo_out,
                             long long* __restrict__ cnt_out) {
  __shared__ long long spl[kSplitters];
  const longlong2 gate = head->gate;
  const bool direct = gate.x != 0;
  const long long mn = gate.y;
  const long long gap = (nb + kSplitters - 1) / kSplitters;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (!direct) {
    // only a block with a valid probe row searches: it copies the
    // splitters (8 KB, coalesced) into shared memory
    bool any = false;
    for (long long i = first; i < np && !any; i += stride)
      any = probe_valid[i];
    if (__syncthreads_or(any)) {
      for (int j = threadIdx.x; j < kSplitters; j += blockDim.x)
        spl[j] = (long long)j * gap < nb ? head->spl[j] : kI64Max;
      __syncthreads();
    }
  }
  for (long long i = first; i < np; i += stride) {
    const long long key = probe[i];
    // an invalid row and a NULL key (INT64_MAX) match nothing; lo is 0
    // where the count is 0, as the reference's direct branch gives
    const bool usable = probe_valid[i] && key != kI64Max;
    long long lo = 0, c = 0;
    if (usable && direct) {
      // the reference's int64 difference, wrapping as it does; a slot no
      // run wrote (uninitialised) fails the key check: no build row
      // carries that key
      const long long off = (long long)((u64)key - (u64)mn);
      if (off >= 0 && off < T) {
        const long long st = (long long)tab[off];
        if (st >= 0 && st < nb && sk[st] == key) {
          lo = st;
          c = run_end(sk, nb, st, key) - st;
        }
      }
    } else if (usable) {
      // the splitters bracket the lower bound to one gap of the keys
      int a = 0, b = kSplitters;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (spl[mid] < key) a = mid + 1; else b = mid;
      }
      long long l = a > 0 ? (long long)(a - 1) * gap + 1 : 0;
      long long h = (long long)a * gap < nb ? (long long)a * gap : nb;
      while (l < h) {
        const long long mid = l + (h - l) / 2;
        if (sk[mid] < key) l = mid + 1; else h = mid;
      }
      if (l < nb && sk[l] == key) {
        lo = l;
        c = run_end(sk, nb, l, key) - l;
      }
    }
    lo_out[i] = lo;
    cnt_out[i] = c;
  }
}

// table: the ProbeHead, then the T slots
template <typename Slot>
void launch_probe(const long long* sk, long long nb, const long long* probe,
                  const bool* pv, long long np, long long T, void* table,
                  long long* lo, long long* cnt, cudaStream_t s) {
  ProbeHead* head = (ProbeHead*)table;
  Slot* tab = (Slot*)((char*)table + sizeof(ProbeHead));
  probe_fill<Slot><<<otbt::grid_for(nb), otbt::kThreads, 0, s>>>(
      sk, nb, T, head, tab);
  probe_kernel<Slot><<<otbt::grid_for(np), otbt::kThreads, 0, s>>>(
      sk, nb, probe, pv, np, T, head, tab, lo, cnt);
}

namespace lb = otbt::lb;

constexpr int kExpThreads = 256;
constexpr int kExpRounds = 8;                     // 16-byte loads a thread
constexpr int kExpWarps = kExpThreads / 32;
constexpr int kExpRoundRows = 2 * kExpThreads;    // 512 rows a round
constexpr int kExpTile = kExpRounds * kExpRoundRows;   // 4096 rows
constexpr int kExpPadBlocks = 264;
constexpr int kExpUnroll = 8;                     // slots a thread a step
// warp 0 scans the (round, warp) runs two a lane
static_assert(kExpRounds * kExpWarps == 64, "64 runs a tile");

struct Expand {
  const long long* counts;
  const bool* probe_valid;   // may be null
  int left_outer;
  const long long* lo;
  const long long* perm;
  long long np, out_size;
  long long* probe_idx;
  long long* build_idx;
  long long* total;
};

// The pair counts of rows i and i + 1 (0 past np).
__device__ __forceinline__ void pair_counts(const Expand& x, long long i,
                                            bool vec, long long& e0,
                                            long long& e1) {
  long long c0 = 0, c1 = 0;
  if (vec && i + 1 < x.np) {
    const longlong2 v =
        __ldg(reinterpret_cast<const longlong2*>(x.counts + i));
    c0 = v.x;
    c1 = v.y;
  } else {
    if (i < x.np) c0 = x.counts[i];
    if (i + 1 < x.np) c1 = x.counts[i + 1];
  }
  if (x.left_outer) {
    const bool* pv = x.probe_valid;
    c0 = i < x.np && (!pv || pv[i]) ? (c0 > 1 ? c0 : 1) : 0;
    c1 = i + 1 < x.np && (!pv || pv[i + 1]) ? (c1 > 1 ? c1 : 1) : 0;
  }
  e0 = c0;
  e1 = c1;
}

// ctrl: the chain's control words (lb::ctrl_words(tiles)), then [0] the
// total is published; pub: the total; agg: one sum a tile; grp: one a
// group of 32 tiles.  Blocks past the tiles write the padding.
__global__ void __launch_bounds__(kExpThreads)
    expand_tiles(Expand x, int tiles, int pad_blocks, int* ctrl,
                 long long* pub, unsigned long long* agg,
                 unsigned long long* grp) {
  __shared__ __align__(16) long long incl[kExpTile];   // 32 KB
  __shared__ unsigned long long wsum[kExpRounds * kExpWarps];
  __shared__ int sh_tile;
  __shared__ long long sh_x, sh_b;
  const lb::Chain<unsigned long long, lb::NoSum> ch{tiles, ctrl, agg,
                                                    nullptr, grp, nullptr};
  const int tile = lb::take_tile(ctrl, &sh_tile);
  int* done = ctrl + lb::ctrl_words(tiles);
  if (tile >= tiles) {
    // a padding block: every tile took its ticket before this one, so
    // every tile is running and the last one publishes the total
    if (threadIdx.x == 0) {
      while (lb::ld_relaxed(done) == 0) {
      }
      __threadfence();
      sh_x = __ldcg(pub);
    }
    __syncthreads();
    const long long from = sh_x < x.out_size ? sh_x : x.out_size;
    const long long step = (long long)pad_blocks * kExpThreads;
    for (long long j = from + (long long)(tile - tiles) * kExpThreads +
                       threadIdx.x;
         j < x.out_size; j += step) {
      x.probe_idx[j] = 0;
      x.build_idx[j] = 0;
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)tile * kExpTile;
  const bool vec = (((unsigned long long)x.counts) & 15ULL) == 0;
  // round k, lane l of warp w: rows 512 k + 64 w + 2 l and + 1 of the tile
  long long e[2 * kExpRounds];
  unsigned long long ex[kExpRounds];   // the pair's offset in its warp's run
#pragma unroll
  for (int k = 0; k < kExpRounds; ++k)
    pair_counts(x, base + k * kExpRoundRows + 64 * warp + 2 * lane, vec,
                e[2 * k], e[2 * k + 1]);
#pragma unroll
  for (int k = 0; k < kExpRounds; ++k) {
    const unsigned long long s =
        (unsigned long long)e[2 * k] + (unsigned long long)e[2 * k + 1];
    const unsigned long long inc = lb::warp_incl(s, lane);
    ex[k] = inc - s;
    if (lane == 31) wsum[k * kExpWarps + warp] = inc;
  }
  __syncthreads();
  if (warp == 0) {
    // the 64 (round, warp) runs in row order, two a lane
    const unsigned long long a = wsum[2 * lane], b = wsum[2 * lane + 1];
    const unsigned long long inc = lb::warp_incl(a + b, lane);
    wsum[2 * lane] = inc - a - b;
    wsum[2 * lane + 1] = inc - b;
    if (lane == 31) sh_b = (long long)inc;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kExpRounds; ++k) {
    const long long off = (long long)(wsum[k * kExpWarps + warp] + ex[k]);
    const int r = k * kExpRoundRows + 64 * warp + 2 * lane;
    *reinterpret_cast<longlong2*>(incl + r) =
        make_longlong2(off + e[2 * k], off + e[2 * k] + e[2 * k + 1]);
  }
  const long long bsum = sh_b;
  if (threadIdx.x == 0)
    lb::publish(ch, tile, (unsigned long long)bsum, lb::NoSum{});
  if (warp == 0) {
    unsigned long long xc;
    lb::NoSum xs;
    lb::look_back(ch, tile, lane, (unsigned long long)bsum, lb::NoSum{}, xc,
                  xs);
    if (lane == 0) sh_x = (long long)xc;
  }
  __syncthreads();
  const long long first = sh_x;
  if (tile == tiles - 1 && threadIdx.x == 0) {
    const long long total = first + bsum;
    *x.total = total;
    *pub = total;
    lb::st_release(done, 1);
  }
  // this tile's slots [first, first + bsum) below out_size, kExpUnroll
  // a thread a step, kExpThreads apart (adjacent threads on adjacent
  // slots).  The row of slot first + j is the first r with incl[r] > j;
  // rows only move forward, so a slot whose row is the last one's (a
  // row with many matches) takes one shared read, else a binary search
  // of the rows after it.  Each step's loads are in flight together.
  long long lim = x.out_size - first;
  if (lim > bsum) lim = bsum;
  int r = 0;
  for (long long j0 = threadIdx.x; j0 < lim;
       j0 += (long long)kExpUnroll * kExpThreads) {
    long long p[kExpUnroll], rank[kExpUnroll], at[kExpUnroll];
#pragma unroll
    for (int u = 0; u < kExpUnroll; ++u) {
      const long long j = j0 + (long long)u * kExpThreads;
      p[u] = -1;
      if (j < lim) {
        if (incl[r] <= j) {
          int lo = r + 1, hi = kExpTile - 1;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (incl[mid] > j) hi = mid; else lo = mid + 1;
          }
          r = lo;
        }
        p[u] = base + r;
        rank[u] = j - (r > 0 ? incl[r - 1] : 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kExpUnroll; ++u)
      at[u] = p[u] >= 0 ? __ldg(x.lo + p[u]) + rank[u] : -1;
    if (x.left_outer) {
#pragma unroll
      for (int u = 0; u < kExpUnroll; ++u)
        if (p[u] >= 0 && __ldg(x.counts + p[u]) == 0) at[u] = -1;
    }
    long long b[kExpUnroll];
#pragma unroll
    for (int u = 0; u < kExpUnroll; ++u)
      b[u] = at[u] >= 0 ? __ldg(x.perm + at[u]) : -1;
#pragma unroll
    for (int u = 0; u < kExpUnroll; ++u) {
      if (p[u] < 0) continue;
      const long long j = first + j0 + (long long)u * kExpThreads;
      x.probe_idx[j] = p[u];
      x.build_idx[j] = b[u];
    }
  }
}

long long expand_tiles_of(long long np) {
  const long long t = (np + kExpTile - 1) / kExpTile;
  return t > 0 ? t : 1;
}

// Scratch of one expansion, in bytes: the control words and the done
// word (zeroed by the call's memset), the total, the tile sums, the
// group sums.
struct ExpandLayout {
  long long zero_bytes, pub, agg, grp, total;
};

ExpandLayout expand_layout(long long np) {
  const long long tiles = expand_tiles_of(np);
  ExpandLayout L;
  L.zero_bytes = 4 * (lb::ctrl_words(tiles) + 1);
  L.pub = (L.zero_bytes + 7) & ~7LL;
  L.agg = L.pub + 8;
  L.grp = L.agg + 8 * tiles;
  L.total = L.grp + 8 * ((tiles + 31) / 32);
  return L;
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

// Bytes of K7's scratch: the branch record and the splitters (8208
// bytes), then T slots of one int32 (int64 when `wide`).
extern "C" long long otbt_probe_table_bytes(long long T, int wide) {
  return (long long)sizeof(ProbeHead) + T * (wide ? 8 : 4);
}

// sorted_keys: nb >= 1; probe, probe_valid: np; T = max(2 nb, np);
// table: otbt_probe_table_bytes(T, wide) bytes; out: 2 x np int64, lo
// then count.  wide: int64 slots (needed from 2^31 build rows on).
// Two launches (fill, probe), no atomics, no initialisation.
extern "C" int otbt_join_probe_counts(const void* sorted_keys, long long nb,
                                      const void* probe,
                                      const void* probe_valid, long long np,
                                      long long T, void* table,
                                      long long table_bytes, int wide,
                                      void* out, void* stream) {
  if (nb < 1 || np < 0 || T < 1 || (!wide && nb >= (1LL << 31)) ||
      table_bytes < otbt_probe_table_bytes(T, wide))
    return (int)cudaErrorInvalidValue;
  if (np == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long* sk = (const long long*)sorted_keys;
  const long long* pk = (const long long*)probe;
  const bool* pv = (const bool*)probe_valid;
  long long* lo = (long long*)out;
  long long* cnt = lo + np;
  if (wide)
    launch_probe<long long>(sk, nb, pk, pv, np, T, table, lo, cnt, s);
  else
    launch_probe<int>(sk, nb, pk, pv, np, T, table, lo, cnt, s);
  return (int)cudaGetLastError();
}

// Scratch bytes of otbt_join_expand over np probe rows.
extern "C" long long otbt_join_expand_scratch_bytes(long long np) {
  return np < 0 ? -1 : expand_layout(np).total;
}

// lo, counts, probe_valid (may be null): np; perm: nb; probe_idx,
// build_idx: out_size (every slot written); total: one int64; scratch:
// otbt_join_expand_scratch_bytes(np) bytes.  One memset of the control
// words, one launch.
extern "C" int otbt_join_expand(const void* lo, const void* counts,
                                const void* perm, const void* probe_valid,
                                long long np, long long nb, int left_outer,
                                void* probe_idx, void* build_idx,
                                long long out_size, void* total,
                                void* scratch, long long scratch_bytes,
                                void* stream) {
  (void)nb;
  if (np < 0 || out_size < 0 ||
      scratch_bytes < otbt_join_expand_scratch_bytes(np))
    return (int)cudaErrorInvalidValue;
  const long long tiles = expand_tiles_of(np);
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ExpandLayout L = expand_layout(np);
  unsigned char* sb = (unsigned char*)scratch;
  cudaError_t e = cudaMemsetAsync(sb, 0, L.zero_bytes, s);
  if (e != cudaSuccess) return (int)e;
  Expand x;
  x.counts = (const long long*)counts;
  x.probe_valid = (const bool*)probe_valid;
  x.left_outer = left_outer;
  x.lo = (const long long*)lo;
  x.perm = (const long long*)perm;
  x.np = np;
  x.out_size = out_size;
  x.probe_idx = (long long*)probe_idx;
  x.build_idx = (long long*)build_idx;
  x.total = (long long*)total;
  long long pad = (out_size + 4 * kExpThreads - 1) / (4 * kExpThreads);
  if (pad > kExpPadBlocks) pad = kExpPadBlocks;
  expand_tiles<<<(unsigned)(tiles + pad), kExpThreads, 0, s>>>(
      x, (int)tiles, (int)pad, (int*)sb, (long long*)(sb + L.pub),
      (unsigned long long*)(sb + L.agg), (unsigned long long*)(sb + L.grp));
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
