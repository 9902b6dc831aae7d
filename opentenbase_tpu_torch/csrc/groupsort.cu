// K5: sort-based GROUP BY, with no host read: key statistics and sort
// words, K10's sort, then one launch that numbers the groups, reduces
// every aggregate and writes the group keys, the filler and n_groups.
//
// Replaces opentenbase_tpu/ops/kernels.py:178 grouped_agg_sort (a lax
// program: pack or lexicographic sort, boundary flags, cumsum, segment
// reductions with indices_are_sorted).  The wrapper (ops/kernels.py)
// runs one sequence of launches in both its forms (eager, and traced
// inside a captured program):
//   1. group_stats: the min and max of each key's int64 image over the
//      valid rows, one partial a block (no atomics, no initialisation);
//      it also zeroes the control words of step 4;
//   2. group_words: every block folds the partials (a few KB, from L2),
//      applies the reference's single-word pack test in float32 (sum of
//      log2(span + 2) over the keys plus log2(n + 2) under 62 bits,
//      spans as uint64) and writes 1 + [k > 1] + k words a row: under
//      the pack word 0 is the packed acc = acc * range + (k - min)
//      (invalid rows: top, the product of the ranges) and the others 0,
//      which sorts as the one packed word does (K10 skips the zero
//      words' passes as a branch); else [invalid, packed (wrapping
//      int64), images...];
//   3. K10's radix sort (sort.cu) orders the words, row index last:
//      valid rows first, each group's rows contiguous, in row order;
//   4. group_reduce: tiles of 1024 sorted rows take tickets
//      (lookback.cuh).  A row starts a group when it is valid and its
//      key images differ from the previous sorted row's; a tile counts
//      its starts, chains the count by the decoupled look-back (group
//      ids), and reduces each aggregate by a segmented scan over its
//      rows (thread, warp, then the warps in order).  A group's keys
//      are written by its first row, its aggregates by its last: a
//      group that began in an earlier tile takes that tile's and the
//      tiles between's published tails, folded in tile order.  The last
//      tile writes n_groups and publishes it to filler blocks (tickets
//      after every tile) that write the plain version's filler past it:
//      sums and counts 0, min and max the dtype's identity, keys of row
//      perm[0].  Groups at or past max_groups are counted, not written.
//      No float atomics: every value is folded in one fixed order, so
//      f64 sums are the same bits on every run.  Up to 32 aggregates a
//      launch (K4's limit), one launch a set of 32 beyond.
// Key images are computed here from each key column in its own dtype:
// ints and bools widen, an f64 rides its bit pattern with -0.0 made 0.0
// and NaN left as it is (ops/kernels.py _sortable_ints: grouping needs
// equality, not order).  Bound: bytes; the sort's active passes over
// the words, then the reduce's random reads through perm (the keys
// twice, every aggregate input once, 8 bytes of perm a row).
#include "common.cuh"
#include "lookback.cuh"

namespace {

namespace lb = otbt::lb;
typedef unsigned long long u64;

constexpr long long kI64Max = 0x7fffffffffffffffLL;
constexpr long long kI64Min = (long long)(1ULL << 63);
constexpr int kMaxKeys = 64;
constexpr int kMaxAggs = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kStatRows = 2048;   // rows a stats block, at least
constexpr int kStatBlocks = 264;
constexpr int kWordBlocks = 528;
constexpr int kItems = 4;               // sorted rows a thread
constexpr int kTile = kThreads * kItems;   // 1024 sorted rows
constexpr int kFillBlocks = 264;

// key column dtypes (ops/kernels.py _KEY_DT)
enum KeyDt { kKI8 = 0, kKU8 = 1, kKI16 = 2, kKI32 = 3, kKI64 = 4, kKF64 = 5 };
// aggregate kinds and input dtypes (K4's codes, ops/kernels.py _agg_code
// and _DT)
enum AggKind { kSumInt = 0, kSumFloat = 1, kMin = 2, kMax = 3, kCount = 4 };
enum ValDt { kVI32 = 0, kVI64 = 1, kVF64 = 2, kVBool = 3 };

struct Keys {
  int k;
  unsigned char dt[kMaxKeys];
  const void* col[kMaxKeys];
};

struct KeyOut {
  void* out[kMaxKeys];
};

struct Aggs {
  int a;          // aggregates of this launch
  int keys_out;   // this launch writes the group keys and n_groups
  unsigned char kind[kMaxAggs];
  unsigned char dt[kMaxAggs];
  unsigned char fl[kMaxAggs];   // the accumulator is an f64
  unsigned char w4[kMaxAggs];   // the output is int32 (min / max of int32)
  long long ident[kMaxAggs];    // the accumulator's identity, as bits
  const void* in[kMaxAggs];
  void* out[kMaxAggs];
};

__device__ __forceinline__ long long key_image(const Keys& K, int c,
                                               long long r) {
  const void* p = K.col[c];
  switch (K.dt[c]) {
    case kKI8: return ((const signed char*)p)[r];
    case kKU8: return ((const unsigned char*)p)[r];
    case kKI16: return ((const short*)p)[r];
    case kKI32: return ((const int*)p)[r];
    case kKI64: return ((const long long*)p)[r];
    default: {
      const double x = ((const double*)p)[r];
      return __double_as_longlong(x == 0.0 ? 0.0 : x);
    }
  }
}

// Key c of row r into group slot g, in the column's own width.
__device__ __forceinline__ void key_store(const Keys& K, const KeyOut& O,
                                          int c, long long r, long long g) {
  const void* p = K.col[c];
  switch (K.dt[c]) {
    case kKI8:
    case kKU8:
      ((unsigned char*)O.out[c])[g] = ((const unsigned char*)p)[r];
      break;
    case kKI16:
      ((unsigned short*)O.out[c])[g] = ((const unsigned short*)p)[r];
      break;
    case kKI32:
      ((unsigned*)O.out[c])[g] = ((const unsigned*)p)[r];
      break;
    default:
      ((u64*)O.out[c])[g] = ((const u64*)p)[r];
  }
}

__device__ __forceinline__ double as_f(long long x) {
  return __longlong_as_double(x);
}
__device__ __forceinline__ long long as_i(double x) {
  return __double_as_longlong(x);
}

// x (earlier rows) folded with y (later rows).  f64 min and max keep a
// NaN, as K4 and XLA do; ties keep the earlier value.
__device__ __forceinline__ long long agg_op(int kind, bool fl, long long x,
                                            long long y) {
  switch (kind) {
    case kSumFloat:
      return as_i(__dadd_rn(as_f(x), as_f(y)));
    case kMin:
      if (fl) {
        const double a = as_f(x), b = as_f(y);
        return a != a ? x : (b != b || b < a ? y : x);
      }
      return y < x ? y : x;
    case kMax:
      if (fl) {
        const double a = as_f(x), b = as_f(y);
        return a != a ? x : (b != b || b > a ? y : x);
      }
      return y > x ? y : x;
    default:   // int sums wrap as int64 does; counts
      return (long long)((u64)x + (u64)y);
  }
}

// Aggregate a's accumulator value of row r.
__device__ __forceinline__ long long agg_value(const Aggs& A, int a,
                                               long long r) {
  const int kind = A.kind[a];
  if (kind == kCount) return 1;
  const void* p = A.in[a];
  long long v;
  switch (A.dt[a]) {
    case kVF64: return ((const long long*)p)[r];
    case kVI32: v = ((const int*)p)[r]; break;
    case kVBool: v = ((const unsigned char*)p)[r]; break;
    default: v = ((const long long*)p)[r];
  }
  return kind == kSumFloat ? as_i((double)v) : v;
}

// Aggregate a's value v into group slot g; an f64 sum starts from +0.0
// as the plain version's does (-0.0 + 0.0 is 0.0).
__device__ __forceinline__ void agg_store(const Aggs& A, int a, long long g,
                                          long long v) {
  if (A.w4[a]) {
    ((int*)A.out[a])[g] = (int)v;
    return;
  }
  ((long long*)A.out[a])[g] =
      A.kind[a] == kSumFloat ? as_i(__dadd_rn(as_f(v), 0.0)) : v;
}

// part: gridDim.x x 2k int64, block b's minima then its maxima; zero:
// zero_words ints set to 0 (the reduce's control words).
__global__ void __launch_bounds__(kThreads)
    group_stats(Keys K, const bool* __restrict__ valid, long long n,
                long long* __restrict__ part, int* __restrict__ zero,
                long long zero_words) {
  __shared__ long long red[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < zero_words; i += stride) zero[i] = 0;
  for (int c = 0; c < K.k; ++c) {
    long long mn = kI64Max, mx = kI64Min;
    for (long long i = first; i < n; i += stride) {
      if (!valid[i]) continue;
      const long long v = key_image(K, c, i);
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const long long a = __shfl_down_sync(lb::kFull, mn, off);
      const long long b = __shfl_down_sync(lb::kFull, mx, off);
      mn = a < mn ? a : mn;
      mx = b > mx ? b : mx;
    }
    if (lane == 0) {
      red[0][warp] = mn;
      red[1][warp] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        mn = red[0][w] < mn ? red[0][w] : mn;
        mx = red[1][w] > mx ? red[1][w] : mx;
      }
      part[(long long)blockIdx.x * 2 * K.k + c] = mn;
      part[(long long)blockIdx.x * 2 * K.k + K.k + c] = mx;
    }
    __syncthreads();
  }
}

// words: (1 + [k > 1] + k) x n; part: G partials of group_stats.
__global__ void __launch_bounds__(kThreads)
    group_words(Keys K, const bool* __restrict__ valid, long long n,
                const long long* __restrict__ part, int G,
                long long* __restrict__ words) {
  __shared__ long long mins[kMaxKeys], maxs[kMaxKeys];
  __shared__ long long gate[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = K.k;
  for (int c = warp; c < k; c += kWarps) {
    long long mn = kI64Max, mx = kI64Min;
    for (int b = lane; b < G; b += 32) {
      const long long a = part[(long long)b * 2 * k + c];
      const long long z = part[(long long)b * 2 * k + k + c];
      mn = a < mn ? a : mn;
      mx = z > mx ? z : mx;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const long long a = __shfl_xor_sync(lb::kFull, mn, off);
      const long long b = __shfl_xor_sync(lb::kFull, mx, off);
      mn = a < mn ? a : mn;
      mx = b > mx ? b : mx;
    }
    if (lane == 0) {
      mins[c] = mn;
      maxs[c] = mx;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the reference's pack test (ops/kernels.py:217-226), in float32
    float bits = 0.0f;
    u64 top = 1;
    for (int c = 0; c < k; ++c) {
      const long long mn = mins[c], mx = maxs[c];
      const u64 span = mx >= mn ? (u64)mx - (u64)mn : 0ULL;
      top *= span + 1ULL;
      bits = __fadd_rn(bits, log2f(__fadd_rn(__ull2float_rn(span), 2.0f)));
    }
    bits = __fadd_rn(bits, log2f(__ll2float_rn(n + 2)));
    const bool fast = bits < 62.0f;
    gate[0] = fast ? 1 : 0;
    gate[1] = fast ? (long long)top : 0;
  }
  __syncthreads();
  const bool fast = gate[0] != 0;
  const long long top = gate[1];
  const int w_all = 1 + (k > 1 ? 1 : 0) + k;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const bool v = valid[i];
    if (fast) {
      // under the pack test every range fits and the product does too
      long long acc = 0;
      for (int c = 0; c < k; ++c) {
        const long long mn = mins[c], mx = maxs[c];
        const long long rng =
            (long long)(mx >= mn ? (u64)mx - (u64)mn : 0ULL) + 1;
        long long d = (long long)((u64)key_image(K, c, i) - (u64)mn);
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
      // the reference's packed int64, wrapping as it does
      u64 packed = 0;
      for (int c = 0; c < k; ++c) {
        const u64 mn = (u64)mins[c], mx = (u64)maxs[c];
        const u64 d = v ? (u64)key_image(K, c, i) - mn : 0ULL;
        packed = packed * (mx - mn + 1ULL) + d;
      }
      words[n + i] = (long long)packed;
      w = 2;
    }
    for (int c = 0; c < k; ++c)
      words[(long long)(w + c) * n + i] = key_image(K, c, i);
  }
}

// One reduce launch's scratch: ctrl (the chain's control words, then
// [0] n_groups is published, then one word a tile: its tails are
// published), zeroed by group_stats; the chain's tile and group counts;
// n_groups for the filler blocks; each tile's tail of every aggregate.
struct RedCtl {
  int* ctrl;
  int* agg_c;
  int* grp_c;
  long long* pub;
  long long* tails;   // tiles x kMaxAggs
};

// v folded over the warp in lane order, the same bits in every lane.
__device__ __forceinline__ long long warp_fold_agg(int kind, bool fl,
                                                   long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_xor_sync(lb::kFull, v, d);
    v = (lane & d) ? agg_op(kind, fl, o, v) : agg_op(kind, fl, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    group_reduce(Keys K, KeyOut KO, const bool* __restrict__ valid,
                 const long long* __restrict__ perm, long long n,
                 long long max_groups, Aggs A,
                 long long* __restrict__ n_groups, RedCtl S, int tiles,
                 int fill_blocks) {
  __shared__ unsigned char fb[kTile + 1];   // bit 0 valid, bit 1 a start
  __shared__ int wcnt[kWarps], wany[kWarps];
  __shared__ long long wv[2][kWarps];
  __shared__ long long head_v[kMaxAggs], head_acc[kMaxAggs];
  __shared__ int sh_tile, sh_head;
  __shared__ long long sh_x;
  const lb::Chain<int, lb::NoSum> ch{tiles, S.ctrl, S.agg_c, nullptr,
                                     S.grp_c, nullptr};
  const int tile = lb::take_tile(S.ctrl, &sh_tile);
  int* done = S.ctrl + lb::ctrl_words(tiles);
  int* tail_ok = done + 1;
  if (tile >= tiles) {
    // a filler block: every tile took its ticket before this one, so
    // every tile is running and the last one publishes n_groups
    if (threadIdx.x == 0) {
      while (lb::ld_relaxed(done) == 0) {
      }
      __threadfence();
      sh_x = __ldcg(S.pub);
    }
    __syncthreads();
    const long long from = sh_x < max_groups ? sh_x : max_groups;
    const long long step = (long long)fill_blocks * kThreads;
    const long long r0 = perm[0];
    for (long long g = from + (long long)(tile - tiles) * kThreads +
                       threadIdx.x;
         g < max_groups; g += step) {
      if (A.keys_out)
        for (int c = 0; c < K.k; ++c) key_store(K, KO, c, r0, g);
      for (int a = 0; a < A.a; ++a) agg_store(A, a, g, A.ident[a]);
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)tile * kTile;
  const long long i0 = base + (long long)threadIdx.x * kItems;
  if (threadIdx.x == 0) sh_head = 0;
  // the thread's sorted rows (r = -1 past n)
  long long r[kItems];
  if (i0 + kItems <= n && (((u64)(perm + i0)) & 15ULL) == 0) {
    const longlong2 p0 = __ldg(reinterpret_cast<const longlong2*>(perm + i0));
    const longlong2 p1 =
        __ldg(reinterpret_cast<const longlong2*>(perm + i0 + 2));
    r[0] = p0.x;
    r[1] = p0.y;
    r[2] = p1.x;
    r[3] = p1.y;
  } else {
#pragma unroll
    for (int q = 0; q < kItems; ++q) r[q] = i0 + q < n ? perm[i0 + q] : -1;
  }
  bool v[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) v[q] = r[q] >= 0 && valid[r[q]];
  // the sorted row before the thread's first
  long long rp = __shfl_up_sync(lb::kFull, r[kItems - 1], 1);
  if (lane == 0) rp = i0 > 0 && i0 <= n ? perm[i0 - 1] : -1;
  // a valid row starts a group when its images differ from the previous
  // row's (valid rows come first, so that row is valid too)
  bool d[kItems] = {false, false, false, false};
  for (int c = 0; c < K.k; ++c) {
    long long x[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) x[q] = v[q] ? key_image(K, c, r[q]) : 0;
    long long xp = __shfl_up_sync(lb::kFull, x[kItems - 1], 1);
    if (lane == 0) xp = v[0] && rp >= 0 ? key_image(K, c, rp) : 0;
    d[0] = d[0] || x[0] != xp;
#pragma unroll
    for (int q = 1; q < kItems; ++q) d[q] = d[q] || x[q] != x[q - 1];
  }
  unsigned f = 0;   // bit q: row q starts a group
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (v[q] && (i0 + q == 0 || d[q])) f |= 1u << q;
    fb[threadIdx.x * kItems + q] =
        (unsigned char)((v[q] ? 1 : 0) | ((f >> q) & 1u ? 2 : 0));
  }
  if (threadIdx.x == kThreads - 1) {
    // the row after the tile: whether it starts a group ends this
    // tile's last group
    const long long i = base + kTile;
    unsigned char b = 0;
    if (i < n) {
      const long long rn = perm[i];
      if (valid[rn]) {
        bool dn = false;
        for (int c = 0; c < K.k && !dn; ++c)
          dn = key_image(K, c, rn) != key_image(K, c, r[kItems - 1]);
        b = (unsigned char)(1 | (dn ? 2 : 0));
      }
    }
    fb[kTile] = b;
  }
  // group ids: the tile's starts scanned, the count chained
  const int cf = __popc(f);
  const int cinc = lb::warp_incl(cf, lane);
  const unsigned any = __ballot_sync(lb::kFull, f != 0);
  if (lane == 31) wcnt[warp] = cinc;
  if (lane == 0) wany[warp] = any != 0;
  __syncthreads();
  int before = 0, cnt = 0;
  bool pf = false;   // a start in the warps before this one
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      before += wcnt[w];
      pf = pf || wany[w];
    }
    cnt += wcnt[w];
  }
  const int fo = before + cinc - cf;   // the tile's starts before the thread
  if (threadIdx.x == 0) lb::publish(ch, tile, cnt, lb::NoSum{});
  if (warp == 0) {
    int xc;
    lb::NoSum xs;
    lb::look_back(ch, tile, lane, cnt, lb::NoSum{}, xc, xs);
    if (lane == 0) sh_x = xc;
  }
  __syncthreads();
  const long long X = sh_x;   // groups started before the tile
  if (tile == tiles - 1 && threadIdx.x == 0) {
    const long long total = X + cnt;
    if (A.keys_out) *n_groups = total;
    *S.pub = total;
    lb::st_release(done, 1);
  }
  // ends: a valid row whose next row is past n, invalid or a start
  unsigned e = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (!v[q]) continue;
    const unsigned char nb = fb[threadIdx.x * kItems + q + 1];
    if (i0 + q + 1 >= n || !(nb & 1) || (nb & 2)) e |= 1u << q;
  }
  if (A.keys_out) {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (!((f >> q) & 1u)) continue;
      const long long g = X + fo + __popc(f & ((2u << q) - 1u)) - 1;
      if (g < max_groups)
        for (int c = 0; c < K.k; ++c) key_store(K, KO, c, r[q], g);
    }
  }
  // the segmented scan's flags (a start in the lane's span so far), the
  // same for every aggregate
  bool fs[5];
  bool F = f != 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    fs[s] = F;
    const bool y = __shfl_up_sync(lb::kFull, F, 1 << s);
    if (lane >= (1 << s)) F = F || y;
  }
  bool fex = __shfl_up_sync(lb::kFull, F, 1);
  if (lane == 0) fex = false;
  const bool tf = pf || fex;   // a start in the tile before the thread
  for (int a = 0; a < A.a; ++a) {
    const int kind = A.kind[a];
    const bool fl = A.fl[a] != 0;
    const long long id = A.ident[a];
    long long s[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) s[q] = v[q] ? agg_value(A, a, r[q]) : id;
#pragma unroll
    for (int q = 1; q < kItems; ++q)
      if (!((f >> q) & 1u)) s[q] = agg_op(kind, fl, s[q - 1], s[q]);
    long long V = s[kItems - 1];
#pragma unroll
    for (int sd = 0; sd < 5; ++sd) {
      const long long y = __shfl_up_sync(lb::kFull, V, 1 << sd);
      if (lane >= (1 << sd) && !fs[sd]) V = agg_op(kind, fl, y, V);
    }
    const long long vex = __shfl_up_sync(lb::kFull, V, 1);
    if (lane == 31) wv[a & 1][warp] = V;
    __syncthreads();
    // the warps before this one, in order, then the lanes before
    long long pv = id;
    for (int w = 0; w < warp; ++w)
      pv = wany[w] ? wv[a & 1][w] : agg_op(kind, fl, pv, wv[a & 1][w]);
    const long long tv =
        lane == 0 ? pv : (fex ? vex : agg_op(kind, fl, pv, vex));
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const bool own = (f & ((2u << q) - 1u)) != 0;
      const long long val = own ? s[q] : agg_op(kind, fl, tv, s[q]);
      if ((e >> q) & 1u) {
        if (own || tf) {
          const long long g = X + fo + __popc(f & ((2u << q) - 1u)) - 1;
          if (g < max_groups) agg_store(A, a, g, val);
        } else {
          // the group began in an earlier tile: its part here
          head_v[a] = val;
          sh_head = 1;
        }
      }
      if (q == kItems - 1 && threadIdx.x == kThreads - 1)
        S.tails[(long long)tile * kMaxAggs + a] = val;
    }
  }
  if (threadIdx.x == kThreads - 1) lb::st_release(tail_ok + tile, 1);
  __syncthreads();
  if (!sh_head || warp != 0) return;
  // the head group began in the nearest tile before this one that holds
  // a start (sorted row 0 is valid when this tile's first row is): its
  // tail, then every tile's between, in tile order, 32 a step
  int t0 = -1;
  for (int top = tile - 1; top >= 0 && t0 < 0; top -= 32) {
    const int q = top - lane;
    bool has = false;
    if (q >= 0) {
      while (lb::ld_relaxed(S.ctrl + 1 + q) == 0) {
      }
      __threadfence();
      has = __ldcg(S.agg_c + q) > 0;
    }
    const unsigned m = __ballot_sync(lb::kFull, has);
    if (m) t0 = top - (__ffs(m) - 1);
  }
  for (int m0 = t0; m0 < tile; m0 += 32) {
    const int j = m0 + lane;
    const bool in = j < tile;
    if (in)
      while (lb::ld_relaxed(tail_ok + j) == 0) {
      }
    __threadfence();
    for (int a = 0; a < A.a; ++a) {
      const int kind = A.kind[a];
      const bool fl = A.fl[a] != 0;
      long long t = in ? __ldcg(S.tails + (long long)j * kMaxAggs + a)
                       : A.ident[a];
      t = warp_fold_agg(kind, fl, t, lane);
      if (lane == 0)
        head_acc[a] = m0 == t0 ? t : agg_op(kind, fl, head_acc[a], t);
    }
  }
  __syncwarp();
  if (lane < A.a && X - 1 < max_groups)
    agg_store(A, lane, X - 1,
              agg_op(A.kind[lane], A.fl[lane] != 0, head_acc[lane],
                     head_v[lane]));
}

// The scratch of one call, in bytes: the stats partials; every reduce
// launch's zeroed words; their tile and group counts; their n_groups and
// tails.
struct Layout {
  long long G, tiles, groups, sets, zero_words;
  long long part, zero, counts, pub, tails, total;
};

Layout layout_of(long long n, int k, int aggs) {
  Layout L;
  L.G = (n + kStatRows - 1) / kStatRows;
  if (L.G > kStatBlocks) L.G = kStatBlocks;
  if (L.G < 1) L.G = 1;
  L.tiles = (n + kTile - 1) / kTile;
  if (L.tiles < 1) L.tiles = 1;
  L.groups = (L.tiles + 31) / 32;
  L.sets = aggs > 0 ? (aggs + kMaxAggs - 1) / kMaxAggs : 1;
  const long long z = lb::ctrl_words(L.tiles) + 1 + L.tiles;   // a set's
  L.zero_words = L.sets * z;
  long long off = 0;
  L.part = off;
  off += 16LL * k * L.G;
  L.zero = off;
  off += 4 * L.zero_words;
  L.counts = off;
  off += 4 * L.sets * (L.tiles + L.groups);
  off = (off + 15) & ~15LL;
  L.pub = off;
  off += 8 * L.sets;
  L.tails = off;
  off += 8LL * kMaxAggs * L.tiles * L.sets;
  L.total = off;
  return L;
}

bool read_keys(const long long* key_ptrs, const int* key_dts, int k,
               Keys* K) {
  if (k < 1 || k > kMaxKeys) return false;
  K->k = k;
  for (int c = 0; c < kMaxKeys; ++c) {
    const bool on = c < k;
    const int dt = on ? key_dts[c] : kKI64;
    if (dt < kKI8 || dt > kKF64) return false;
    K->dt[c] = (unsigned char)dt;
    K->col[c] = on ? (const void*)key_ptrs[c] : nullptr;
  }
  return true;
}

}  // namespace

// Scratch bytes of otbt_group_words + otbt_group_reduce over n rows, k
// keys and `aggs` aggregates.
extern "C" long long otbt_group_scratch_bytes(long long n, int k, int aggs) {
  if (n < 1 || k < 1 || k > kMaxKeys || aggs < 0) return -1;
  return layout_of(n, k, aggs).total;
}

// Steps 1-2: key_ptrs / key_dts: HOST arrays of k key columns (n rows,
// KeyDt); words: (1 + [k > 1] + k) x n int64.  Two launches, no host
// read; they also zero the reduce's control words in the scratch.
extern "C" int otbt_group_words(const long long* key_ptrs,
                                const int* key_dts, int k, long long n,
                                const void* valid, int aggs, void* scratch,
                                long long scratch_bytes, void* words,
                                void* stream) {
  Keys K;
  if (n < 1 || !read_keys(key_ptrs, key_dts, k, &K) ||
      scratch_bytes < otbt_group_scratch_bytes(n, k, aggs))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(n, k, aggs);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* sb = (unsigned char*)scratch;
  long long* part = (long long*)(sb + L.part);
  group_stats<<<(unsigned)L.G, kThreads, 0, s>>>(
      K, (const bool*)valid, n, part, (int*)(sb + L.zero), L.zero_words);
  long long wb = (n + kThreads - 1) / kThreads;
  if (wb > kWordBlocks) wb = kWordBlocks;
  group_words<<<(unsigned)wb, kThreads, 0, s>>>(
      K, (const bool*)valid, n, part, (int)L.G, (long long*)words);
  return (int)cudaGetLastError();
}

// Step 4, after the sort (perm: n).  key_outs: k group-key outputs of
// max_groups rows (the key columns' widths); in_ptrs / kinds / dtypes /
// idents / out_ptrs: HOST arrays of `aggs` aggregates (K4's kind and
// dtype codes, the identity's bits, outputs of max_groups rows);
// n_groups: one int64.  One launch a set of 32 aggregates (one for
// none); the scratch is otbt_group_words' own, after it.
extern "C" int otbt_group_reduce(const long long* key_ptrs,
                                 const int* key_dts,
                                 const long long* key_outs, int k,
                                 long long n, const void* valid,
                                 const void* perm, long long max_groups,
                                 int aggs, const long long* in_ptrs,
                                 const int* kinds, const int* dtypes,
                                 const long long* idents,
                                 const long long* out_ptrs, void* n_groups,
                                 void* scratch, long long scratch_bytes,
                                 void* stream) {
  Keys K;
  if (n < 1 || max_groups < 1 || !read_keys(key_ptrs, key_dts, k, &K) ||
      scratch_bytes < otbt_group_scratch_bytes(n, k, aggs))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(n, k, aggs);
  if (L.tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  KeyOut KO;
  for (int c = 0; c < kMaxKeys; ++c)
    KO.out[c] = c < k ? (void*)key_outs[c] : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* sb = (unsigned char*)scratch;
  long long fill = (max_groups + 4 * kThreads - 1) / (4 * kThreads);
  if (fill > kFillBlocks) fill = kFillBlocks;
  const long long z = L.zero_words / L.sets;
  for (long long set = 0; set < L.sets; ++set) {
    Aggs A;
    const long long lo = set * kMaxAggs;
    A.a = (int)(aggs - lo < kMaxAggs ? aggs - lo : kMaxAggs);
    if (A.a < 0) A.a = 0;
    A.keys_out = set == 0;
    for (int j = 0; j < kMaxAggs; ++j) {
      const bool on = j < A.a;
      const int kind = on ? kinds[lo + j] : kSumInt;
      const int dt = on ? dtypes[lo + j] : kVI64;
      if (kind < kSumInt || kind > kCount || dt < kVI32 || dt > kVBool)
        return (int)cudaErrorInvalidValue;
      A.kind[j] = (unsigned char)kind;
      A.dt[j] = (unsigned char)dt;
      A.fl[j] = kind == kSumFloat ||
                ((kind == kMin || kind == kMax) && dt == kVF64);
      A.w4[j] = (kind == kMin || kind == kMax) && dt == kVI32;
      A.ident[j] = on ? idents[lo + j] : 0;
      A.in[j] = on ? (const void*)in_ptrs[lo + j] : nullptr;
      A.out[j] = on ? (void*)out_ptrs[lo + j] : nullptr;
    }
    RedCtl S;
    S.ctrl = (int*)(sb + L.zero) + set * z;
    S.agg_c = (int*)(sb + L.counts) + set * (L.tiles + L.groups);
    S.grp_c = S.agg_c + L.tiles;
    S.pub = (long long*)(sb + L.pub) + set;
    S.tails = (long long*)(sb + L.tails) + set * kMaxAggs * L.tiles;
    group_reduce<<<(unsigned)(L.tiles + fill), kThreads, 0, s>>>(
        K, KO, (const bool*)valid, (const long long*)perm, n, max_groups, A,
        (long long*)n_groups, S, (int)L.tiles, (int)fill);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
