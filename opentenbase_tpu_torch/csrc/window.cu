// Window functions (K13): partition and peer bounds of sorted rows, one
// window function per call over its frames, and the min/max sparse
// table.
//
// Replaces opentenbase_tpu/exec/executor.py:1523 _exec_window (everything
// after its lax.sort, which the port does with K10's radix sort over the
// order words), :1733 _frame_bounds and :1765 _range_minmax.  The
// reference computes bounds with jnp.roll compares, lax.cummax/cummin
// and jnp.cumsum scans, a segment_max for the partition's last valid row
// and a stacked log-doubling table; each becomes a kernel here:
//
//   otbt_window_bounds        (K13a) neighbour-compare flags, then six
//                             block scans: p_start and peer_start
//                             (max of boundary indices), ob_cum (count
//                             of order boundaries), the last valid row
//                             so far (max), and backwards the next peer
//                             and partition boundary (min); one pass
//                             finishes p_end and peer_end_v.
//   otbt_window_frame_reduce  (K13b) one single-pass scan of the
//                             contributions (count, and the int64 or f64
//                             values for sum/avg: a decoupled look-back,
//                             below), then one kernel: each row's frame
//                             [fs, fe], its function and the scatter of
//                             the result and its null to input order.
//   otbt_range_minmax         (K13c) the sparse table, one launch per
//                             level; K13b queries it by two spans.
//
// K13a's scans are three-phase (tile reduce, one block scans the tile
// totals, each tile scans again from its carry), Hillis-Steele in shared
// memory, generic over the operator.  Bound: bytes.  Integer sums wrap
// like the reference's int64 cumsum (unsigned adds); f64 sums add the
// finite values of each partition on their own, in another order than
// the CPU's (a fixed one: the same bits every run), exact for
// integer-valued data below 2^53.  Unlike the reference's one
// whole-array prefix, a NaN, an infinity or a huge value in one
// partition does not reach another's frames; cancellation by a huge
// value inside a partition remains (PostgreSQL sums each frame).
#include <limits>
#include <type_traits>

#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kT = 256;
constexpr int kItems = 4;
constexpr int kTile = kT * kItems;   // rows per scan tile (ops/kernels.py _WIN_TILE)
constexpr long long kInfWord = 0x7FF0000000000000LL;   // order word of +inf
constexpr long long kI64Max = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kI64Min = -kI64Max - 1;

enum Func { ROW_NUMBER, RANK, DENSE_RANK, LAG, LEAD, COUNT, SUM, AVG,
            FIRST_VALUE, LAST_VALUE, MIN, MAX };
enum Bound { UNBOUNDED_PRECEDING, PRECEDING, CURRENT, FOLLOWING,
             UNBOUNDED_FOLLOWING };

struct OpSum {
  __device__ __forceinline__ long long operator()(long long a,
                                                  long long b) const {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
};
struct OpMax {
  __device__ __forceinline__ long long operator()(long long a,
                                                  long long b) const {
    return a > b ? a : b;
  }
};
struct OpMin {
  __device__ __forceinline__ long long operator()(long long a,
                                                  long long b) const {
    return a < b ? a : b;
  }
};

// ---- three-phase scan ------------------------------------------------

// Block-wide inclusive scan of one value per thread (sh: kT entries).
// On return sh holds the block's inclusive scan.
template <class T, class Op>
__device__ __forceinline__ T block_incl(T v, T* sh, Op op) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < kT; off <<= 1) {
    T x = sh[t];
    if (t >= off) x = op(sh[t - off], x);
    __syncthreads();
    sh[t] = x;
    __syncthreads();
  }
  return sh[t];
}

template <class T, class Op, class Load>
__global__ void tile_reduce(Load load, long long n, int rev, T ident, Op op,
                            T* __restrict__ aggs) {
  __shared__ T sh[kT];
  long long base = (long long)blockIdx.x * kTile +
                   (long long)threadIdx.x * kItems;
  T s = ident;
  for (int q = 0; q < kItems; ++q) {
    long long v = base + q;
    if (v < n) s = op(s, load(rev ? n - 1 - v : v));
  }
  T incl = block_incl(s, sh, op);
  if (threadIdx.x == kT - 1) aggs[blockIdx.x] = incl;
}

// One block: aggs becomes its own exclusive scan.
template <class T, class Op>
__global__ void tile_offsets(T* __restrict__ aggs, long long tiles, T ident,
                             Op op) {
  __shared__ T sh[kT];
  T carry = ident;
  for (long long b = 0; b < tiles; b += kT) {
    long long i = b + threadIdx.x;
    T v = i < tiles ? aggs[i] : ident;
    block_incl(v, sh, op);
    T ex = threadIdx.x > 0 ? sh[threadIdx.x - 1] : ident;
    T total = sh[kT - 1];
    __syncthreads();
    if (i < tiles) aggs[i] = op(carry, ex);
    carry = op(carry, total);
  }
}

template <class T, class Op, class Load, class Store>
__global__ void tile_scan(Load load, Store store, long long n, int rev,
                          T ident, Op op, const T* __restrict__ offs) {
  __shared__ T sh[kT];
  long long base = (long long)blockIdx.x * kTile +
                   (long long)threadIdx.x * kItems;
  T v[kItems];
  T s = ident;
  for (int q = 0; q < kItems; ++q) {
    long long x = base + q;
    v[q] = x < n ? load(rev ? n - 1 - x : x) : ident;
    s = op(s, v[q]);
  }
  block_incl(s, sh, op);
  T run = op(offs[blockIdx.x], threadIdx.x > 0 ? sh[threadIdx.x - 1] : ident);
  for (int q = 0; q < kItems; ++q) {
    long long x = base + q;
    run = op(run, v[q]);
    if (x < n) store(rev ? n - 1 - x : x, run);
  }
}

// Inclusive scan of load(0..n-1) (rev: from the end) into store;
// scratch holds ceil(n / kTile) values of T.
template <class T, class Op, class Load, class Store>
void scan(Load load, Store store, long long n, bool rev, T ident, Op op,
          T* scratch, cudaStream_t s) {
  long long tiles = (n + kTile - 1) / kTile;
  if (tiles == 0) return;
  tile_reduce<T, Op, Load><<<(unsigned)tiles, kT, 0, s>>>(
      load, n, rev ? 1 : 0, ident, op, scratch);
  tile_offsets<T, Op><<<1, kT, 0, s>>>(scratch, tiles, ident, op);
  tile_scan<T, Op, Load, Store><<<(unsigned)tiles, kT, 0, s>>>(
      load, store, n, rev ? 1 : 0, ident, op, scratch);
}

// ---- loaders and stores ----------------------------------------------

// i where flag bit `bit` is set, else `other`
struct FlagIdx {
  const unsigned char* f;
  unsigned char bit;
  long long other;
  __device__ __forceinline__ long long operator()(long long i) const {
    return (f[i] & bit) ? i : other;
  }
};
struct FlagOne {
  const unsigned char* f;
  unsigned char bit;
  __device__ __forceinline__ long long operator()(long long i) const {
    return (f[i] & bit) ? 1LL : 0LL;
  }
};
struct ValidIdx {
  const unsigned char* v;
  __device__ __forceinline__ long long operator()(long long i) const {
    return v[i] ? i : -1LL;
  }
};
__device__ __forceinline__ bool contributes(const unsigned char* valid,
                                            const unsigned char* anm,
                                            long long i) {
  return valid[i] && !(anm != nullptr && anm[i]);
}
template <class T>
struct StoreT {
  T* o;
  __device__ __forceinline__ void operator()(long long i, T x) const {
    o[i] = x;
  }
};

// ---- K13a ------------------------------------------------------------

// bit 0: partition boundary, bit 1: peer (order) boundary.  Words 1 ..
// n_part are partition keys, the rest order keys; word 0 (~valid) is
// not compared, as the reference compares keys only.  A float key's NaN
// is never equal to its neighbour.
__global__ void bound_flags(const long long* __restrict__ words, int n_words,
                            int n_part, unsigned long long float_mask,
                            long long n, unsigned char* __restrict__ flags) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool pb = i == 0, ob = false;
    if (i > 0) {
      for (int w = 1; w < n_words; ++w) {
        long long x = words[(long long)w * n + i];
        long long y = words[(long long)w * n + i - 1];
        bool d = x != y || (((float_mask >> w) & 1ULL) && x > kInfWord);
        if (w <= n_part)
          pb = pb || d;
        else
          ob = ob || d;
      }
    }
    flags[i] = (unsigned char)((pb ? 1 : 0) | ((pb || ob) ? 2 : 0));
  }
}

__global__ void bound_finish(long long n, const long long* __restrict__ gv,
                             const long long* __restrict__ nxt_o,
                             const long long* __restrict__ nxt_p,
                             const long long* __restrict__ p_start,
                             long long* __restrict__ peer_end_v,
                             long long* __restrict__ p_end) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long pe = (i + 1 < n ? nxt_o[i + 1] : n) - 1;
    long long pl = (i + 1 < n ? nxt_p[i + 1] : n) - 1;
    long long g = gv[pl];
    long long e = g >= p_start[i] ? g : -1;
    p_end[i] = e;
    peer_end_v[i] = pe < e ? pe : e;
  }
}

// ---- K13b ------------------------------------------------------------
//
// Two launches for a frame function (plus one memset): wfr_scan writes
// the exclusive prefix of the contribution count (int32) and, for
// sum / avg, of the contributing values, in one pass, and clears the
// null mask; wfr_frame reads each row's frame bounds, gathers the two
// prefixes at its ends, computes the function and scatters to input
// order (of the null mask only the NULL rows' bytes).  The ranks, lag /
// lead and first / last value are wfr_frame alone.  Bound: bytes; the
// scatter, a random 8-byte write a row, sets wfr_frame's time.
//
// wfr_scan is a decoupled look-back scan (lookback.cuh, shared with K3's
// compaction): a block loads 16 rows a thread (16-byte loads), scans them
// in registers, across the warp with shuffles and across the 8 warps
// through shared memory, publishes its aggregate and takes its exclusive
// prefix from the look-back.  Only finite values enter an f64 sum, and
// the f64 prefix restarts at each partition start (p_start[i] == i): a
// segmented scan whose segment flag travels with every aggregate, so a
// NaN, an infinity or a huge value in one partition leaves the others'
// sums alone.  An f64 argument's NaN, +inf and -inf rows are counted
// beside the count (Cnt4), so wfr_frame makes a frame with a NaN, or
// with both infinities, NaN, and one with one infinity that infinity.
// Integer sums stay one wrapping int64 prefix (exact in any order).
constexpr int kLbThreads = 256;
constexpr int kLbItems = 16;
constexpr int kLbTile = kLbThreads * kLbItems;   // 4096 rows a tile
constexpr int kLbWarps = kLbThreads / 32;

using otbt::lb::Cnt4;
using otbt::lb::NoSum;
using otbt::lb::SegF;

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ULL) == 0;
}
__device__ __forceinline__ int byte_bit(const unsigned (&w)[4], int q) {
  return (int)((w[q >> 2] >> ((q & 3) * 8)) & 1u);
}

struct ScanArgs {
  long long n;
  const unsigned char* valid;
  const unsigned char* anm;   // the argument's NULLs, or null
  const void* a;              // the argument (sum / avg only)
  const long long* p_start;   // partition starts (f64 sums only)
  int tiles;
  int* ctrl;     // the look-back's control words (lookback.cuh)
  void* agg_c;   // per tile: its count (and sum: agg_s)
  void* agg_s;
  void* grp_c;   // per group: S(g), the count (and sum: grp_s)
  void* grp_s;
  void* ex_c;    // n + 1 exclusive counts (C)
  void* ex_s;    // n + 1 exclusive sums (int64, or f64 within the
                 // partition)
  unsigned char* out_null;   // cleared here (input order), or null
};

// the f64 / int64 value a sum of type V stores a row
template <class V> struct SumOf { using T = int; };
template <> struct SumOf<unsigned long long> {
  using T = unsigned long long;
};
template <> struct SumOf<SegF> { using T = double; };

// C: int or Cnt4 (the count, and an f64 argument's non-finite counts);
// V: NoSum, unsigned long long (wraps as int64 does) or SegF (an f64
// sum restarted at each partition start); A: the argument's type.
template <class C, class V, class A>
__global__ void __launch_bounds__(kLbThreads) wfr_scan(ScanArgs p) {
  constexpr bool kSum = otbt::lb::kHasSum<V>;
  constexpr bool kSeg = std::is_same<V, SegF>::value;
  constexpr bool kNF = std::is_same<C, Cnt4>::value;
  using S = typename SumOf<V>::T;
  namespace lb = otbt::lb;
  __shared__ int sh_tile;
  __shared__ C sh_xc;
  __shared__ V sh_xs;
  __shared__ C sh_wc[kLbWarps];
  __shared__ V sh_ws[kLbWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const lb::Chain<C, V> ch{p.tiles, p.ctrl, (C*)p.agg_c, (V*)p.agg_s,
                           (C*)p.grp_c, (V*)p.grp_s};
  const int tile = lb::take_tile(p.ctrl, &sh_tile);
  const long long n = p.n;
  const long long r0 = (long long)tile * kLbTile + (long long)t * kLbItems;
  const bool full = r0 + kLbItems <= n;

  // contribution bytes (valid and not NULL, 0 or 1) of the 16 rows
  unsigned cw[4] = {0u, 0u, 0u, 0u};
  if (full && aligned16(p.valid) &&
      (p.anm == nullptr || aligned16(p.anm))) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p.valid + r0));
    cw[0] = v.x; cw[1] = v.y; cw[2] = v.z; cw[3] = v.w;
    if (p.anm != nullptr) {
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(p.anm + r0));
      cw[0] &= ~m.x; cw[1] &= ~m.y; cw[2] &= ~m.z; cw[3] &= ~m.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kLbItems; ++q)
      if (r0 + q < n && contributes(p.valid, p.anm, r0 + q))
        cw[q >> 2] |= 1u << ((q & 3) * 8);
  }
  // the summed values (0 where a row adds nothing), the non-finite class
  // of each row (2 bits: 1 NaN, 2 +inf, 3 -inf) and the partition starts
  S v[kLbItems];
  unsigned cls = 0u, seg = 0u;
#pragma unroll
  for (int q = 0; q < kLbItems; ++q) v[q] = S(0);
  if constexpr (kSum) {
    const A* a = (const A*)p.a;
    A x[kLbItems];
    if (full && aligned16(a)) {
#pragma unroll
      for (int k = 0; k < kLbItems / 2; ++k) {
        if constexpr (std::is_same<A, double>::value) {
          const double2 d =
              __ldg(reinterpret_cast<const double2*>(a + r0) + k);
          x[2 * k] = d.x; x[2 * k + 1] = d.y;
        } else {
          const longlong2 d =
              __ldg(reinterpret_cast<const longlong2*>(a + r0) + k);
          x[2 * k] = d.x; x[2 * k + 1] = d.y;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kLbItems; ++q)
        x[q] = r0 + q < n ? a[r0 + q] : A(0);
    }
#pragma unroll
    for (int q = 0; q < kLbItems; ++q) {
      if (!byte_bit(cw, q)) continue;
      if constexpr (kNF) {
        const double d = (double)x[q];
        if (d != d)
          cls |= 1u << (2 * q);
        else if (isinf(d))
          cls |= (d > 0 ? 2u : 3u) << (2 * q);
        else
          v[q] = (S)d;
      } else {
        v[q] = (S)x[q];
      }
    }
    if constexpr (kSeg) {
      if (full && aligned16(p.p_start)) {
#pragma unroll
        for (int k = 0; k < kLbItems / 2; ++k) {
          const longlong2 d =
              __ldg(reinterpret_cast<const longlong2*>(p.p_start + r0) + k);
          seg |= (d.x == r0 + 2 * k ? 1u : 0u) << (2 * k);
          seg |= (d.y == r0 + 2 * k + 1 ? 1u : 0u) << (2 * k + 1);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kLbItems; ++q)
          if (r0 + q < n && p.p_start[r0 + q] == r0 + q) seg |= 1u << q;
      }
    }
  }
  auto row_c = [&](int q) -> C {
    if constexpr (kNF) {
      const unsigned k = (cls >> (2 * q)) & 3u;
      Cnt4 r;
      r.c = byte_bit(cw, q);
      r.nan = k == 1u;
      r.pinf = k == 2u;
      r.minf = k == 3u;
      return r;
    } else {
      return byte_bit(cw, q);
    }
  };
  auto row_s = [&](int q) -> V {
    if constexpr (kSeg) {
      SegF r;
      r.s = v[q];
      r.f = (int)((seg >> q) & 1u);
      r.pad = 0;
      return r;
    } else if constexpr (kSum) {
      return v[q];
    } else {
      return NoSum{};
    }
  };
  C tc = lb::zero<C>();
  V ts = lb::zero<V>();
#pragma unroll
  for (int q = 0; q < kLbItems; ++q) {
    tc = lb::combine(tc, row_c(q));
    ts = lb::combine(ts, row_s(q));
  }

  // warp scan of the thread totals, then the warps' totals in order
  const C ic = lb::warp_incl(tc, lane);
  const V is = lb::warp_incl(ts, lane);
  C ec = lb::shfl<0>(ic, 1);
  V es = lb::shfl<0>(is, 1);
  if (lane == 0) {
    ec = lb::zero<C>();
    es = lb::zero<V>();
  }
  if (lane == 31) {
    sh_wc[warp] = ic;
    sh_ws[warp] = is;
  }
  __syncthreads();
  C wc = lb::zero<C>(), bc = lb::zero<C>();
  V wsum = lb::zero<V>(), bs = lb::zero<V>();
#pragma unroll
  for (int k = 0; k < kLbWarps; ++k) {
    if (k == warp) {
      wc = bc;
      wsum = bs;
    }
    bc = lb::combine(bc, sh_wc[k]);
    bs = lb::combine(bs, sh_ws[k]);
  }

  // publish this tile's aggregate, then look back
  if (t == 0) lb::publish(ch, tile, bc, bs);
  if (warp == 0) {
    C xc;
    V xs;
    lb::look_back(ch, tile, lane, bc, bs, xc, xs);
    if (lane == 0) {
      sh_xc = xc;
      sh_xs = xs;
    }
  }
  __syncthreads();

  // each row's exclusive prefix (an f64 sum's within its partition: 0 at
  // its start); row n - 1's owner also writes [n].  The prefixes and the
  // cleared null mask are stored evict-first, so the frame pass's
  // scattered results keep their lines in L2 until they fill (with the
  // default policy the frame pass was slower).
  C rc = lb::combine(lb::combine(sh_xc, wc), ec);
  V rs = lb::combine(lb::combine(sh_xs, wsum), es);
  S ex[kLbItems];
  auto sum_of = [&](const V& r) -> S {
    if constexpr (kSeg) return r.s;
    else if constexpr (kSum) return r;
    else return S(0);
  };
  int* ex_c1 = (int*)p.ex_c;
  Cnt4* ex_c4 = (Cnt4*)p.ex_c;
  S* ex_s = (S*)p.ex_s;
  int cs[kLbItems];
#pragma unroll
  for (int q = 0; q < kLbItems; ++q) {
    if constexpr (kSeg)
      ex[q] = ((seg >> q) & 1u) ? S(0) : sum_of(rs);
    else
      ex[q] = sum_of(rs);
    if constexpr (kNF) {
      if (r0 + q < n)
        __stcs(reinterpret_cast<int4*>(ex_c4 + r0 + q),
               make_int4(rc.c, rc.nan, rc.pinf, rc.minf));
    } else {
      cs[q] = rc;
    }
    rc = lb::combine(rc, row_c(q));
    rs = lb::combine(rs, row_s(q));
  }
  if constexpr (!kNF) {
    if (full) {
#pragma unroll
      for (int k = 0; k < kLbItems / 4; ++k)
        __stcs(reinterpret_cast<int4*>(ex_c1 + r0) + k,
               make_int4(cs[4 * k], cs[4 * k + 1], cs[4 * k + 2],
                         cs[4 * k + 3]));
    } else {
#pragma unroll
      for (int q = 0; q < kLbItems; ++q)
        if (r0 + q < n) ex_c1[r0 + q] = cs[q];
    }
  }
  if constexpr (kSum) {
    if (full) {
#pragma unroll
      for (int k = 0; k < kLbItems / 2; ++k) {
        if constexpr (std::is_same<S, double>::value)
          __stcs(reinterpret_cast<double2*>(ex_s + r0) + k,
                 make_double2(ex[2 * k], ex[2 * k + 1]));
        else
          __stcs(reinterpret_cast<longlong2*>(ex_s + r0) + k,
                 make_longlong2((long long)ex[2 * k],
                                (long long)ex[2 * k + 1]));
      }
    } else {
#pragma unroll
      for (int q = 0; q < kLbItems; ++q)
        if (r0 + q < n) ex_s[r0 + q] = ex[q];
    }
  }
  // clear the null mask: the frame pass then writes only the NULL rows,
  // a scattered byte a row saved where results are rarely NULL
  if (p.out_null != nullptr) {
    if (full && aligned16(p.out_null))
      __stcs(reinterpret_cast<uint4*>(p.out_null + r0),
             make_uint4(0u, 0u, 0u, 0u));
    else
      for (int q = 0; q < kLbItems; ++q)
        if (r0 + q < n) p.out_null[r0 + q] = 0;
  }
  if (r0 < n && r0 + kLbItems >= n) {
    if constexpr (kNF)
      ex_c4[n] = rc;
    else
      ex_c1[n] = rc;
    if constexpr (kSum) ex_s[n] = sum_of(rs);
  }
}

struct WinArgs {
  long long n;
  const long long *p_start, *peer_start, *peer_end_v, *p_end, *ob_cum;
  const long long* s_iota;
  const unsigned char* s_valid;
  const void* a;
  int a_float;
  const unsigned char* anm;
  long long offset;
  const void* dflt;
  const unsigned char* dnull;
  int has_default;
  double pow10;
  const void* table;
  int levels;
  int mode, sbk, ebk, has_order;
  long long sk, ek;
  const void* ex_c;   // wfr_scan's outputs: counts (int, or Cnt4: nf)
  const void* ex_s;
  int sum_float;
  int nf;             // ex_c holds an f64 argument's non-finite counts
  long long* out;   // 8-byte results (int64 or f64 bits)
  unsigned char* out_null;
};

__device__ __forceinline__ long long rows_bound(int kind, long long k,
                                                long long i, long long ps,
                                                long long pe) {
  switch (kind) {
    case UNBOUNDED_PRECEDING: return ps;
    case PRECEDING: return i - k;
    case CURRENT: return i;
    case FOLLOWING: return i + k;
    default: return pe;
  }
}

__device__ __forceinline__ double minmax_f(double x, double y, bool is_min) {
  if (x != x) return x;   // NaN propagates, as jnp.minimum / maximum
  if (y != y) return y;
  return is_min ? (x < y ? x : y) : (x > y ? x : y);
}
__device__ __forceinline__ long long minmax_i(long long x, long long y,
                                              bool is_min) {
  return is_min ? (x < y ? x : y) : (x > y ? x : y);
}

// One row a thread, the function a template argument.  The row's own
// entries stream (evict-first loads), so the scattered results stay in
// L2 until their lines fill.
// The count prefix at row i: (count, NaN, +inf, -inf).
__device__ __forceinline__ int4 count_at(const WinArgs& w, long long i) {
  if (w.nf) return __ldg(reinterpret_cast<const int4*>(w.ex_c) + i);
  return make_int4(((const int*)w.ex_c)[i], 0, 0, 0);
}

template <int F>
__global__ void __launch_bounds__(256) wfr_frame(WinArgs w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = w.n;
  if (i >= n) return;
  const long long* ai = (const long long*)w.a;
  const double* af = (const double*)w.a;
  const long long ps = __ldcs(w.p_start + i);
  long long bits = 0;
  bool nul = false;
  if constexpr (F == ROW_NUMBER) {
    bits = i - ps + 1;
  } else if constexpr (F == RANK) {
    bits = __ldcs(w.peer_start + i) - ps + 1;
  } else if constexpr (F == DENSE_RANK) {
    bits = __ldcs(w.ob_cum + i) - w.ob_cum[ps] + 1;
  } else if constexpr (F == LAG || F == LEAD) {
    long long src = F == LAG ? i - w.offset : i + w.offset;
    long long srcc = src < 0 ? 0 : (src > n - 1 ? n - 1 : src);
    bool inside = src >= 0 && src < n && w.p_start[srcc] == ps &&
                  w.s_valid[srcc];
    bits = ai[srcc];
    bool src_null = w.anm != nullptr && w.anm[srcc];
    if (w.has_default) {
      if (!inside) bits = __ldcs((const long long*)w.dflt + i);
      nul = (inside && src_null) ||
            (!inside && w.dnull != nullptr && __ldcs(w.dnull + i));
    } else {
      nul = !inside || src_null;
    }
  } else {
    const long long pe = __ldcs(w.p_end + i);
    long long fs, fe;
    if (w.mode == 0) {
      fs = ps;
      fe = w.has_order ? __ldcs(w.peer_end_v + i) : pe;
    } else if (w.mode == 1) {
      fs = rows_bound(w.sbk, w.sk, i, ps, pe);
      fe = rows_bound(w.ebk, w.ek, i, ps, pe);
      fs = fs > ps ? fs : ps;
      fe = fe < pe ? fe : pe;
    } else {
      fs = w.sbk == UNBOUNDED_PRECEDING ? ps : __ldcs(w.peer_start + i);
      fe = w.ebk == UNBOUNDED_FOLLOWING ? pe : __ldcs(w.peer_end_v + i);
    }
    const long long fsc = fs < 0 ? 0 : (fs > n - 1 ? n - 1 : fs);
    const long long fec = fe < 0 ? 0 : (fe > n - 1 ? n - 1 : fe);
    const bool empty = fe < fs || !__ldcs(w.s_valid + i);
    long long rcount = 0;
    if constexpr (F != FIRST_VALUE && F != LAST_VALUE)
      if (!empty)
        rcount = (long long)(count_at(w, fec + 1).x - count_at(w, fsc).x);
    if constexpr (F == COUNT) {
      bits = rcount;
    } else if constexpr (F == FIRST_VALUE || F == LAST_VALUE) {
      const long long pos = F == FIRST_VALUE ? fsc : fec;
      bits = ai[pos];
      nul = empty || (w.anm != nullptr && w.anm[pos]);
    } else if constexpr (F == MIN || F == MAX) {
      long long len = fec - fsc + 1;
      if (len < 1) len = 1;
      int j = 63 - __clzll(len);
      if (j > w.levels - 1) j = w.levels - 1;
      if (j < 0) j = 0;
      const long long span = 1LL << j;
      long long hi_at = fec - span + 1;
      if (hi_at < 0) hi_at = 0;
      const bool is_min = F == MIN;
      if (w.a_float) {
        const double* t = (const double*)w.table + (long long)j * n;
        bits = __double_as_longlong(minmax_f(t[fsc], t[hi_at], is_min));
      } else {
        const long long* t = (const long long*)w.table + (long long)j * n;
        bits = minmax_i(t[fsc], t[hi_at], is_min);
      }
      nul = rcount == 0;
    } else {   // SUM, AVG
      if (w.sum_float) {
        // the partition's prefix through fe less its prefix before fs
        // (ex_s is exclusive within the partition; fs and fe lie in one
        // partition), over the finite values; then the non-finite counts
        const double* sc = (const double*)w.ex_s;
        double ve = 0.0;
        if (contributes(w.s_valid, w.anm, fec)) {
          const double x = w.a_float ? af[fec] : (double)ai[fec];
          if (isfinite(x)) ve = x;
        }
        double rsum = empty ? 0.0 : (sc[fec] + ve) - sc[fsc];
        if (w.nf && !empty) {
          const int4 hi = count_at(w, fec + 1), lo = count_at(w, fsc);
          const bool nan = hi.y > lo.y, pinf = hi.z > lo.z,
                     minf = hi.w > lo.w;
          if (nan || (pinf && minf))
            rsum = __longlong_as_double(0x7FF8000000000000LL);
          else if (pinf)
            rsum = __longlong_as_double(0x7FF0000000000000LL);
          else if (minf)
            rsum = -__longlong_as_double(0x7FF0000000000000LL);
        }
        if constexpr (F == AVG) {
          const double den = (double)(rcount > 1 ? rcount : 1);
          const double r = rcount > 0 ? rsum / den / w.pow10 : 0.0;
          bits = __double_as_longlong(r);
        } else {
          bits = __double_as_longlong(rsum);
        }
      } else {
        // wrapping int64 sums: the order of the adds does not matter
        const unsigned long long* sc = (const unsigned long long*)w.ex_s;
        bits = empty ? 0LL : (long long)(sc[fec + 1] - sc[fsc]);
      }
      nul = rcount == 0;
    }
  }
  const long long dst = __ldcs(w.s_iota + i);
  w.out[dst] = bits;
  if constexpr (F == SUM || F == AVG || F == MIN || F == MAX) {
    if (nul && w.out_null != nullptr) w.out_null[dst] = 1;   // cleared
  } else {
    if (w.out_null != nullptr) w.out_null[dst] = nul ? 1 : 0;
  }
}

template <int F>
void launch_frame(const WinArgs& w, cudaStream_t s) {
  wfr_frame<F><<<(unsigned)((w.n + 255) / 256), 256, 0, s>>>(w);
}

// Byte offsets of the K13b scratch regions (each 256-aligned).  sums:
// the function is sum or avg; seg: its sum is f64 (SegF, 16 bytes an
// aggregate); nf: the argument is f64 (Cnt4 counts, 16 bytes a row).
struct ScanLayout {
  long long tiles, groups, ctrl, agg_c, agg_s, grp_c, grp_s, ex_c, ex_s,
      total;
};

ScanLayout scan_layout(long long n, bool sums, bool seg, bool nf) {
  auto up = [](long long b) { return (b + 255) & ~255LL; };
  const long long cb = nf ? 16 : 4, vb = !sums ? 0 : (seg ? 16 : 8);
  ScanLayout L;
  L.tiles = (n + kLbTile - 1) / kLbTile;
  L.groups = (L.tiles + 31) / 32;
  long long off = 0;
  L.ctrl = off;  off += up(4 * otbt::lb::ctrl_words(L.tiles));
  L.agg_c = off; off += up(cb * L.tiles);
  L.agg_s = off; off += up(vb * L.tiles);
  L.grp_c = off; off += up(cb * L.groups);
  L.grp_s = off; off += up(vb * L.groups);
  L.ex_c = off;  off += up(cb * (n + 1));
  L.ex_s = off;  off += sums ? up(8 * (n + 1)) : 0;
  L.total = off;
  return L;
}

// ---- K13c ------------------------------------------------------------

template <class T>
__global__ void minmax_level0(const T* __restrict__ a,
                              const unsigned char* __restrict__ contrib,
                              long long n, T neutral, T* __restrict__ t0) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    t0[i] = contrib[i] ? a[i] : neutral;
}

template <class T>
__global__ void minmax_level(const T* __restrict__ prev, long long n,
                             long long half, T neutral, int is_min,
                             T* __restrict__ next) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T y = i + half < n ? prev[i + half] : neutral;
    if constexpr (std::is_floating_point<T>::value)
      next[i] = minmax_f(prev[i], y, is_min != 0);
    else
      next[i] = minmax_i(prev[i], y, is_min != 0);
  }
}

template <class T>
void build_table(const void* a, const void* contrib, long long n, int levels,
                 T neutral, int is_min, void* table, cudaStream_t s) {
  T* t = (T*)table;
  minmax_level0<T><<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
      (const T*)a, (const unsigned char*)contrib, n, neutral, t);
  for (int j = 0; j + 1 < levels; ++j)
    minmax_level<T><<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
        t + (long long)j * n, n, 1LL << j, neutral, is_min,
        t + (long long)(j + 1) * n);
}

}  // namespace

// K13a.  words: n_words x n sorted order words; flags: n bytes; gv, nxt_o,
// nxt_p: n int64 each; tiles: ceil(n / 1024) int64; outputs p_start,
// peer_start, peer_end_v, p_end, ob_cum: n int64 each.
extern "C" int otbt_window_bounds(const void* words, int n_words, int n_part,
                                  long long float_mask, long long n,
                                  const void* s_valid, void* flags, void* gv,
                                  void* nxt_o, void* nxt_p, void* tiles,
                                  void* p_start, void* peer_start,
                                  void* peer_end_v, void* p_end, void* ob_cum,
                                  void* stream) {
  if (n < 1 || n_words < 1 || n_words > 64 || n_part < 0 ||
      n_part >= n_words)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* f = (const unsigned char*)flags;
  long long* sc = (long long*)tiles;
  bound_flags<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
      (const long long*)words, n_words, n_part,
      (unsigned long long)float_mask, n, (unsigned char*)flags);
  scan<long long>(FlagIdx{f, 1, 0}, StoreT<long long>{(long long*)p_start},
                  n, false, kI64Min, OpMax(), sc, s);
  scan<long long>(FlagIdx{f, 2, 0}, StoreT<long long>{(long long*)peer_start},
                  n, false, kI64Min, OpMax(), sc, s);
  scan<long long>(FlagOne{f, 2}, StoreT<long long>{(long long*)ob_cum}, n,
                  false, 0LL, OpSum(), sc, s);
  scan<long long>(ValidIdx{(const unsigned char*)s_valid},
                  StoreT<long long>{(long long*)gv}, n, false, kI64Min,
                  OpMax(), sc, s);
  scan<long long>(FlagIdx{f, 2, n}, StoreT<long long>{(long long*)nxt_o}, n,
                  true, kI64Max, OpMin(), sc, s);
  scan<long long>(FlagIdx{f, 1, n}, StoreT<long long>{(long long*)nxt_p}, n,
                  true, kI64Max, OpMin(), sc, s);
  bound_finish<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
      n, (const long long*)gv, (const long long*)nxt_o,
      (const long long*)nxt_p, (const long long*)p_start,
      (long long*)peer_end_v, (long long*)p_end);
  return (int)cudaGetLastError();
}

// K13b scratch bytes over n rows for function `func` over an argument
// that is f64 (a_float) or not; 0 when the function reads no prefix.
extern "C" long long otbt_window_scratch_bytes(long long n, int func,
                                               int a_float) {
  if (n < 1 || func < ROW_NUMBER || func > MAX) return -1;
  bool counts = func == COUNT || func == SUM || func == AVG ||
                func == MIN || func == MAX;
  if (!counts) return 0;
  const bool sums = func == SUM || func == AVG;
  const bool seg = sums && (a_float || func == AVG);
  return scan_layout(n, sums, seg, sums && a_float).total;
}

// K13b.  scratch: otbt_window_scratch_bytes(n, func, a_float) bytes,
// 16-byte aligned; out: n 8-byte results; out_null: n bytes or null.
extern "C" int otbt_window_frame_reduce(
    int func, long long n, const void* p_start, const void* peer_start,
    const void* peer_end_v, const void* p_end, const void* ob_cum,
    const void* s_iota, const void* s_valid, const void* a, int a_float,
    const void* anm, long long offset, const void* dflt, const void* dnull,
    int has_default, double pow10, const void* table, int levels, int mode,
    int sbk, long long sk, int ebk, long long ek, int has_order,
    void* scratch, long long scratch_bytes, void* out, void* out_null,
    void* stream) {
  // the count prefix is int32: n < 2^31 (bounds alone take 40 n bytes)
  if (n < 1 || n >= (1LL << 31) - 1 || func < ROW_NUMBER || func > MAX)
    return (int)cudaErrorInvalidValue;
  bool needs_a = !(func <= DENSE_RANK || func == COUNT);
  if (needs_a && a == nullptr) return (int)cudaErrorInvalidValue;
  if ((func == MIN || func == MAX) && (table == nullptr || levels < 1))
    return (int)cudaErrorInvalidValue;
  if (has_default && dflt == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* valid = (const unsigned char*)s_valid;
  const unsigned char* nm = (const unsigned char*)anm;
  const bool counts = func == COUNT || func == SUM || func == AVG ||
                      func == MIN || func == MAX;
  const bool sums = func == SUM || func == AVG;
  const int sum_float = (a_float || func == AVG) ? 1 : 0;
  const bool nf = sums && a_float;
  char* base = (char*)scratch;
  ScanLayout L = scan_layout(n, sums, sums && sum_float, nf);
  if (counts) {
    if (scratch == nullptr || scratch_bytes < L.total ||
        ((unsigned long long)scratch & 15ULL) != 0)
      return (int)cudaErrorInvalidValue;
    ScanArgs p;
    p.n = n;
    p.valid = valid;
    p.anm = nm;
    p.a = a;
    p.p_start = (const long long*)p_start;
    p.tiles = (int)L.tiles;
    p.ctrl = (int*)(base + L.ctrl);
    p.agg_c = base + L.agg_c;
    p.agg_s = base + L.agg_s;
    p.grp_c = base + L.grp_c;
    p.grp_s = base + L.grp_s;
    p.ex_c = base + L.ex_c;
    p.ex_s = base + L.ex_s;
    p.out_null = func == COUNT ? nullptr : (unsigned char*)out_null;
    cudaError_t e = cudaMemsetAsync(
        p.ctrl, 0, 4 * otbt::lb::ctrl_words(L.tiles), s);
    if (e != cudaSuccess) return (int)e;
    const unsigned grid = (unsigned)L.tiles;
    if (!sums)
      wfr_scan<int, NoSum, long long><<<grid, kLbThreads, 0, s>>>(p);
    else if (!sum_float)
      wfr_scan<int, unsigned long long, long long>
          <<<grid, kLbThreads, 0, s>>>(p);
    else if (a_float)
      wfr_scan<Cnt4, SegF, double><<<grid, kLbThreads, 0, s>>>(p);
    else
      wfr_scan<int, SegF, long long><<<grid, kLbThreads, 0, s>>>(p);
  }
  WinArgs w;
  w.n = n;
  w.p_start = (const long long*)p_start;
  w.peer_start = (const long long*)peer_start;
  w.peer_end_v = (const long long*)peer_end_v;
  w.p_end = (const long long*)p_end;
  w.ob_cum = (const long long*)ob_cum;
  w.s_iota = (const long long*)s_iota;
  w.s_valid = valid;
  w.a = a;
  w.a_float = a_float;
  w.anm = nm;
  w.offset = offset;
  w.dflt = dflt;
  w.dnull = (const unsigned char*)dnull;
  w.has_default = has_default;
  w.pow10 = pow10;
  w.table = table;
  w.levels = levels;
  w.mode = mode;
  w.sbk = sbk;
  w.ebk = ebk;
  w.has_order = has_order;
  w.sk = sk;
  w.ek = ek;
  w.ex_c = counts ? (const void*)(base + L.ex_c) : nullptr;
  w.ex_s = sums ? (const void*)(base + L.ex_s) : nullptr;
  w.sum_float = sum_float;
  w.nf = nf ? 1 : 0;
  w.out = (long long*)out;
  w.out_null = (unsigned char*)out_null;
  switch (func) {
    case ROW_NUMBER: launch_frame<ROW_NUMBER>(w, s); break;
    case RANK: launch_frame<RANK>(w, s); break;
    case DENSE_RANK: launch_frame<DENSE_RANK>(w, s); break;
    case LAG: launch_frame<LAG>(w, s); break;
    case LEAD: launch_frame<LEAD>(w, s); break;
    case COUNT: launch_frame<COUNT>(w, s); break;
    case SUM: launch_frame<SUM>(w, s); break;
    case AVG: launch_frame<AVG>(w, s); break;
    case FIRST_VALUE: launch_frame<FIRST_VALUE>(w, s); break;
    case LAST_VALUE: launch_frame<LAST_VALUE>(w, s); break;
    case MIN: launch_frame<MIN>(w, s); break;
    default: launch_frame<MAX>(w, s); break;
  }
  return (int)cudaGetLastError();
}

// K13c.  table: levels x n values of a's type (int64 or f64).
extern "C" int otbt_range_minmax(const void* a, int a_float,
                                 const void* contrib, long long n, int levels,
                                 int is_min, void* table, void* stream) {
  if (n < 1 || levels < 1 || (1LL << (levels - 1)) > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a_float) {
    const double inf = std::numeric_limits<double>::infinity();
    build_table<double>(a, contrib, n, levels, is_min ? inf : -inf, is_min,
                        table, s);
  } else {
    build_table<long long>(a, contrib, n, levels, is_min ? kI64Max : kI64Min,
                           is_min, table, s);
  }
  return (int)cudaGetLastError();
}
