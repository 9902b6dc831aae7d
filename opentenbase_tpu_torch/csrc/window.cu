// Window functions (K13): partition and peer bounds of sorted rows, one
// window function per launch over its frames, and the min/max sparse
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
//   otbt_window_frame_reduce  (K13b) block scans of the contributions
//                             (count, and the int64 or f64 values for
//                             sum/avg), then one kernel: each row's frame
//                             [fs, fe], its function and the scatter of
//                             the result and its null to input order.
//   otbt_range_minmax         (K13c) the sparse table, one launch per
//                             level; K13b queries it by two spans.
//
// Scans are three-phase (tile reduce, one block scans the tile totals,
// each tile scans again from its carry), Hillis-Steele in shared memory,
// generic over the operator: simple and right at any n; a decoupled
// look-back is later work.  Bound: bytes.  Integer sums wrap like the
// reference's int64 cumsum (unsigned adds); f64 sums add in another
// order than the CPU's sequential cumsum, exact for integer-valued
// data below 2^53.
#include <limits>
#include <type_traits>

#include "common.cuh"

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
  __device__ __forceinline__ double operator()(double a, double b) const {
    return a + b;
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
struct ContribOne {
  const unsigned char* valid;
  const unsigned char* anm;
  __device__ __forceinline__ long long operator()(long long i) const {
    return contributes(valid, anm, i) ? 1LL : 0LL;
  }
};
// the argument at i as T where it contributes, else 0
template <class T>
struct ContribVal {
  const unsigned char* valid;
  const unsigned char* anm;
  const void* a;
  int a_float;
  __device__ __forceinline__ T operator()(long long i) const {
    if (!contributes(valid, anm, i)) return T(0);
    return a_float ? (T)((const double*)a)[i] : (T)((const long long*)a)[i];
  }
};
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

struct WinArgs {
  int func;
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
  const long long* ccum;
  const void* scum;
  int sum_float;
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

__global__ void frame_reduce(WinArgs w) {
  long long stride = (long long)gridDim.x * blockDim.x;
  const long long n = w.n;
  const long long* ai = (const long long*)w.a;
  const double* af = (const double*)w.a;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long ps = w.p_start[i];
    long long bits = 0;
    bool nul = false;
    if (w.func == ROW_NUMBER) {
      bits = i - ps + 1;
    } else if (w.func == RANK) {
      bits = w.peer_start[i] - ps + 1;
    } else if (w.func == DENSE_RANK) {
      bits = w.ob_cum[i] - w.ob_cum[ps] + 1;
    } else if (w.func == LAG || w.func == LEAD) {
      long long src = w.func == LAG ? i - w.offset : i + w.offset;
      long long srcc = src < 0 ? 0 : (src > n - 1 ? n - 1 : src);
      bool inside = src >= 0 && src < n && w.p_start[srcc] == ps &&
                    w.s_valid[srcc];
      bits = ai[srcc];
      bool src_null = w.anm != nullptr && w.anm[srcc];
      if (w.has_default) {
        if (!inside) bits = ((const long long*)w.dflt)[i];
        nul = (inside && src_null) ||
              (!inside && w.dnull != nullptr && w.dnull[i]);
      } else {
        nul = !inside || src_null;
      }
    } else {
      const long long pe = w.p_end[i];
      long long fs, fe;
      if (w.mode == 0) {
        fs = ps;
        fe = w.has_order ? w.peer_end_v[i] : pe;
      } else if (w.mode == 1) {
        fs = rows_bound(w.sbk, w.sk, i, ps, pe);
        fe = rows_bound(w.ebk, w.ek, i, ps, pe);
        fs = fs > ps ? fs : ps;
        fe = fe < pe ? fe : pe;
      } else {
        fs = w.sbk == UNBOUNDED_PRECEDING ? ps : w.peer_start[i];
        fe = w.ebk == UNBOUNDED_FOLLOWING ? pe : w.peer_end_v[i];
      }
      long long fsc = fs < 0 ? 0 : (fs > n - 1 ? n - 1 : fs);
      long long fec = fe < 0 ? 0 : (fe > n - 1 ? n - 1 : fe);
      bool empty = fe < fs || !w.s_valid[i];
      bool c_fs = contributes(w.s_valid, w.anm, fsc);
      long long rcount = 0;
      if (w.ccum != nullptr && !empty)
        rcount = w.ccum[fec] - (w.ccum[fsc] - (c_fs ? 1 : 0));
      if (w.func == COUNT) {
        bits = rcount;
      } else if (w.func == FIRST_VALUE || w.func == LAST_VALUE) {
        long long pos = w.func == FIRST_VALUE ? fsc : fec;
        bits = ai[pos];
        nul = empty || (w.anm != nullptr && w.anm[pos]);
      } else if (w.func == MIN || w.func == MAX) {
        long long len = fec - fsc + 1;
        if (len < 1) len = 1;
        int j = 63 - __clzll(len);
        if (j > w.levels - 1) j = w.levels - 1;
        if (j < 0) j = 0;
        long long span = 1LL << j;
        long long hi_at = fec - span + 1;
        if (hi_at < 0) hi_at = 0;
        bool is_min = w.func == MIN;
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
          const double* sc = (const double*)w.scum;
          double av = 0.0;
          if (c_fs) av = w.a_float ? af[fsc] : (double)ai[fsc];
          double sex = sc[fsc] - av;
          double rsum = empty ? 0.0 : sc[fec] - sex;
          if (w.func == AVG) {
            double den = (double)(rcount > 1 ? rcount : 1);
            double r = rcount > 0 ? rsum / den / w.pow10 : 0.0;
            bits = __double_as_longlong(r);
          } else {
            bits = __double_as_longlong(rsum);
          }
        } else {
          const unsigned long long* sc = (const unsigned long long*)w.scum;
          unsigned long long av = c_fs ? (unsigned long long)ai[fsc] : 0ULL;
          unsigned long long sex = sc[fsc] - av;
          bits = empty ? 0LL : (long long)(sc[fec] - sex);
        }
        nul = rcount == 0;
      }
    }
    const long long dst = w.s_iota[i];
    w.out[dst] = bits;
    if (w.out_null != nullptr) w.out_null[dst] = nul ? 1 : 0;
  }
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

// K13b.  ccum, scum: n int64 (or f64) scratch; tiles: ceil(n / 1024)
// int64; out: n 8-byte results; out_null: n bytes or null.
extern "C" int otbt_window_frame_reduce(
    int func, long long n, const void* p_start, const void* peer_start,
    const void* peer_end_v, const void* p_end, const void* ob_cum,
    const void* s_iota, const void* s_valid, const void* a, int a_float,
    const void* anm, long long offset, const void* dflt, const void* dnull,
    int has_default, double pow10, const void* table, int levels, int mode,
    int sbk, long long sk, int ebk, long long ek, int has_order, void* ccum,
    void* scum, void* tiles, void* out, void* out_null, void* stream) {
  if (n < 1 || func < ROW_NUMBER || func > MAX) return (int)cudaErrorInvalidValue;
  bool needs_a = !(func <= DENSE_RANK || func == COUNT);
  if (needs_a && a == nullptr) return (int)cudaErrorInvalidValue;
  if ((func == MIN || func == MAX) && (table == nullptr || levels < 1))
    return (int)cudaErrorInvalidValue;
  if (has_default && dflt == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* valid = (const unsigned char*)s_valid;
  const unsigned char* nm = (const unsigned char*)anm;
  bool counts = func == COUNT || func == SUM || func == AVG ||
                func == MIN || func == MAX;
  bool sums = func == SUM || func == AVG;
  int sum_float = (a_float || func == AVG) ? 1 : 0;
  if (counts)
    scan<long long>(ContribOne{valid, nm}, StoreT<long long>{(long long*)ccum},
                    n, false, 0LL, OpSum(), (long long*)tiles, s);
  if (sums) {
    if (sum_float)
      scan<double>(ContribVal<double>{valid, nm, a, a_float},
                   StoreT<double>{(double*)scum}, n, false, 0.0, OpSum(),
                   (double*)tiles, s);
    else
      scan<long long>(ContribVal<long long>{valid, nm, a, a_float},
                      StoreT<long long>{(long long*)scum}, n, false, 0LL,
                      OpSum(), (long long*)tiles, s);
  }
  WinArgs w;
  w.func = func;
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
  w.ccum = counts ? (const long long*)ccum : nullptr;
  w.scum = scum;
  w.sum_float = sum_float;
  w.out = (long long*)out;
  w.out_null = (unsigned char*)out_null;
  frame_reduce<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(w);
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
