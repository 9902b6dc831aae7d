// Dense grouped aggregation (K4): fold the valid rows into num_groups slots.
//
// Replaces opentenbase_tpu/ops/kernels.py:133 grouped_agg_dense (XLA
// segment_sum / segment_min / segment_max).  Bound: bytes (each input
// read once; TPC-H Q1's call reads 11 aggregates of 6,291,456 padded rows,
// about 610 MB).  A call's table is W = (k + 1) x num_groups words: k
// aggregates and `present` (the per-group count of in-range valid rows).
// Q1 sends 6 M rows into 6 slots, so accumulators shared between threads
// serialise on a handful of addresses.  Three branches, by W against the
// card's shared memory (plan_for):
//
// - private (small tables: Q1's 12 x 6 words, the one-group aggregates,
//   the cluster's partial sums): every thread folds its rows into a
//   table of its own in shared memory, slot-major (word s of thread t at
//   s x T + t, so the 32 lanes of a warp always touch 32 different
//   banks, whatever their groups), with no atomics.  A thread takes four
//   pairs of adjacent rows a step (8 rows), reading each input of a pair
//   as one vector load where the dtype and the alignment allow, and
//   loads no input of a pair whose rows are both invalid or out of
//   range; the loads of 4 aggregates of the 4 pairs are in flight
//   together, and the fold of an aggregate is chosen once for the step's
//   rows.  The block then folds its threads' tables into one partial,
//   each slot in a fixed order (finish); the last block of each group of
//   32 (a ticket a group) folds the group's partials, and the last group
//   those of the groups, and writes every output, an empty group's
//   identity included.  Chosen when the table of each thread leaves at
//   least 8 resident warps an SM.
// - block (medium tables: TPC-DS's dense keys of 40-96 groups, up to
//   about 3600 groups at 3 aggregates): one launch sets every output to
//   its identity; a second folds each row into its block's table in
//   shared memory by shared-memory atomics, then each slot that left its
//   identity into the outputs by one global atomic.  Chosen when the
//   tables leave at least 16 resident warps an SM.
// - global (larger tables: `_hits` and `first_idx` at the padded row
//   count, dense keys near 4096 groups): the same two launches, each row
//   folded straight into the outputs by global atomics.
//
// The private branch uses no atomic but the tickets, and its grid depends
// only on n, the table and the card: its f64 sums are the same bits on
// every call with the same input.  On the block and global branches int
// sums and counts are atomicAdd (exact in any order), min/max atomicMin /
// atomicMax or, for f64, a compare-and-swap loop (any NaN wins, as in
// fold); their f64 sums are atomicAdd on double, in an order that changes
// from run to run.
//
// Semantics (the reference's): int sums widen to int64 (two's complement
// wrap), f64 min/max propagate NaN as XLA's do, an empty group's min/max
// is the dtype's max/min, and a row that is not valid or whose group id
// is outside [0, num_groups) contributes nothing.
#include <atomic>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kMaxAggs = 32;
constexpr int kPairs = 4;         // pairs of rows a thread takes a step
constexpr int kChunk = 4;         // aggregates whose loads it issues together
constexpr int kMinPrivateWarps = 8;   // resident warps an SM the private branch keeps
// and the block branch: with fewer its atomics wait on each other
// (parent_turns.py's dense keys on the H100: at 4096 groups x 3
// aggregates, a 128 KB table and 8 warps an SM, a block-table kernel took
// 2.6x the global branch's time; at 2048 groups, 24 warps, 0.8x)
constexpr int kMinBlockWarps = 16;
constexpr int kStaticSmem = 64;       // bytes of static shared memory a block
enum Kind { kSumInt = 0, kSumFloat = 1, kMin = 2, kMax = 3, kCount = 4 };
enum DType { kI32 = 0, kI64 = 1, kF64 = 2, kBool = 3 };
// how an accumulator folds: int64 add, f64 add, int64 min/max, f64 min/max
enum Op { kAddI = 0, kAddF = 1, kMinI = 2, kMaxI = 3, kMinF = 4, kMaxF = 5 };
enum Branch { kPrivate = 0, kBlock = 1, kGlobal = 2 };

struct AggArgs {
  int n_aggs;
  int kind[kMaxAggs];
  int dtype[kMaxAggs];
  int op[kMaxAggs];
  long long ident[kMaxAggs];     // identity bit pattern of each accumulator
  const void* in[kMaxAggs];
  void* out[kMaxAggs + 1];       // the outputs, then present
  int out32[kMaxAggs];           // output a is int32 (min/max over int32)
};

__device__ __forceinline__ double as_f64(unsigned long long w) {
  return __longlong_as_double((long long)w);
}

__device__ __forceinline__ unsigned long long as_word(double x) {
  return (unsigned long long)__double_as_longlong(x);
}

// a (the earlier value) folded with b; f64 min/max keep the first NaN.
// Selects, not a switch: where op is only known at run time (the block
// and merge folds) a switch becomes an indirect branch, where it is a
// constant (fold_rows) the selects fold away.
__device__ __forceinline__ unsigned long long fold(int op, unsigned long long a,
                                                   unsigned long long b) {
  const long long ia = (long long)a, ib = (long long)b;
  const double x = as_f64(a), y = as_f64(b);
  const bool xn = x != x, yn = y != y;
  unsigned long long r = a + b;
  r = op == kAddF ? as_word(__dadd_rn(x, y)) : r;
  r = op == kMinI ? (ib < ia ? b : a) : r;
  r = op == kMaxI ? (ib > ia ? b : a) : r;
  r = op == kMinF ? ((xn || !(yn || y < x)) ? a : b) : r;
  r = op == kMaxF ? ((xn || !(yn || y > x)) ? a : b) : r;
  return r;
}

__device__ __forceinline__ int slot_op(const AggArgs& args, int a) {
  return a < args.n_aggs ? args.op[a] : kAddI;
}

__device__ __forceinline__ unsigned long long slot_ident(const AggArgs& args,
                                                         int a) {
  return a < args.n_aggs ? (unsigned long long)args.ident[a] : 0ULL;
}

// a row's raw input as an int64 (ints sign-extended, bools 0/1, f64 bits)
__device__ __forceinline__ long long load_raw(const void* p, int dt,
                                              long long i) {
  switch (dt) {
    case kI32: return (long long)__ldg((const int*)p + i);
    case kBool: return (long long)__ldg((const unsigned char*)p + i);
    default: return __ldg((const long long*)p + i);
  }
}

// rows i and i + 1 (i even) by one vector load
__device__ __forceinline__ void load_raw2(const void* p, int dt, long long i,
                                          long long& r0, long long& r1) {
  switch (dt) {
    case kI32: {
      const int2 v = __ldg((const int2*)((const int*)p + i));
      r0 = v.x;
      r1 = v.y;
      break;
    }
    case kBool: {
      const uchar2 v = __ldg((const uchar2*)((const unsigned char*)p + i));
      r0 = v.x;
      r1 = v.y;
      break;
    }
    default: {
      const longlong2 v = __ldg((const longlong2*)((const long long*)p + i));
      r0 = v.x;
      r1 = v.y;
    }
  }
}

// the accumulator word of a raw input: an f64 add of an int converts it
__device__ __forceinline__ unsigned long long to_word(const AggArgs& args,
                                                      int a, long long raw) {
  if (args.kind[a] == kCount) return 1ULL;
  if (args.op[a] == kAddF && args.dtype[a] != kF64)
    return as_word((double)raw);
  return (unsigned long long)raw;
}

__device__ __forceinline__ void write_out(const AggArgs& args, int G,
                                          long long s, unsigned long long v) {
  const int a = (int)(s / G);
  const long long g = s - (long long)a * G;
  if (a < args.n_aggs && args.out32[a])
    ((int*)args.out[a])[g] = (int)(long long)v;
  else
    ((unsigned long long*)args.out[a])[g] = v;
}

constexpr int kGroupBlocks = 32;   // blocks whose partials one merge folds

// Block-level end of the private branch: the block's slots
// are the fold of `count` rows of its shared table (row r's slot s at
// tab[r rs + s ss]).  With one block the block writes the outputs.
// Else each block writes its partial (block b's slot s at
// partials[b W + s]); the last block of each group of kGroupBlocks
// (a ticket a group) folds the group's partials in block order into
// gparts, and the last group (one more ticket) folds those in group order
// and writes the outputs, each empty group's identity included.  Each
// fold gives a slot P lanes (the largest power of two up to 32 that keeps
// the block's threads busy): lane p folds rows p, p + P, ... in a fixed
// order (the threads' tables of the private branch from row s on, so the
// lanes of a warp read 32 banks; every other fold from row 0), eight
// loads in flight, then the P lanes fold in a fixed tree.  One loop runs
// the three levels, so its code is there once.
__device__ __forceinline__ void finish(const AggArgs& args, int G, int W,
                                       const unsigned long long* tab,
                                       long long rs, long long ss, int count,
                                       unsigned long long* __restrict__ partials,
                                       int* __restrict__ tickets) {
  __shared__ int sh_last;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int nb = gridDim.x;
  const int ng = (nb + kGroupBlocks - 1) / kGroupBlocks;
  const int grp = blockIdx.x / kGroupBlocks;
  unsigned long long* gparts = partials + (long long)nb * W;
  const unsigned long long* src = tab;
  bool l2 = false;
  int P = 1;
  while (P < 32 && 2 * P * W <= (int)blockDim.x) P <<= 1;
  for (int level = 0;; ++level) {
    // where this level's folds go: the outputs, or a partial
    unsigned long long* dst = nullptr;
    if (level == 0 && nb > 1) dst = partials + (long long)blockIdx.x * W;
    if (level == 1 && ng > 1) dst = gparts + (long long)grp * W;
#pragma unroll 1
    for (int i0 = threadIdx.x - lane; i0 < W * P; i0 += blockDim.x) {
      const int i = i0 + lane, sl = i / P, part = i % P;
      const bool live = sl < W;
      const int a = live ? sl / G : 0;
      const int op = slot_op(args, a);
      const int skew = !l2 && rs == 1 ? sl % count : 0;
      unsigned long long v = slot_ident(args, a);
#pragma unroll 1
      for (int j0 = part; live && j0 < count; j0 += 8 * P) {
        unsigned long long x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u * P;
          int r = j + skew;
          if (r >= count) r -= count;
          const unsigned long long* q = src + r * rs + sl * ss;
          x[u] = j < count ? (l2 ? __ldcg(q) : *q) : 0ULL;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (j0 + u * P < count) v = fold(op, v, x[u]);
      }
      for (int o = 1; o < P; o <<= 1) {
        const unsigned long long x = __shfl_down_sync(full, v, o, P);
        if ((part & (2 * o - 1)) == 0) v = fold(op, v, x);
      }
      if (live && part == 0) {
        if (dst)
          dst[sl] = v;
        else
          write_out(args, G, sl, v);
      }
    }
    if (!dst) return;
    // a ticket: the last block of the group (level 0) or the last group
    __threadfence();
    __syncthreads();
    const int members = level == 0 ? (grp == ng - 1 ? nb - grp * kGroupBlocks
                                                    : kGroupBlocks)
                                   : ng;
    if (threadIdx.x == 0)
      sh_last = atomicAdd(tickets + (level == 0 ? grp : ng), 1) == members - 1;
    __syncthreads();
    if (!sh_last) return;
    __threadfence();
    src = level == 0 ? partials + (long long)grp * kGroupBlocks * W : gparts;
    rs = W;
    ss = 1;
    count = members;
    l2 = true;
  }
}

__device__ __forceinline__ void atomic_min_f64(unsigned long long* addr,
                                               double v) {
  unsigned long long old = *addr, assumed;
  do {
    assumed = old;
    const double cur = as_f64(assumed);
    if (cur != cur) return;                  // NaN already: stays NaN
    if (!(v != v || v < cur)) return;        // nothing to do
    old = atomicCAS(addr, assumed, as_word(v));
  } while (old != assumed);
}

__device__ __forceinline__ void atomic_max_f64(unsigned long long* addr,
                                               double v) {
  unsigned long long old = *addr, assumed;
  do {
    assumed = old;
    const double cur = as_f64(assumed);
    if (cur != cur) return;
    if (!(v != v || v > cur)) return;
    old = atomicCAS(addr, assumed, as_word(v));
  } while (old != assumed);
}

// w folded into *p by an atomic: int64 add, f64 add, int64 min/max, f64
// min/max by compare-and-swap (a chain of tests: a switch on a run-time
// op becomes an indirect branch)
__device__ __forceinline__ void atomic_fold(int op, unsigned long long* p,
                                            unsigned long long w) {
  if (op == kAddI)
    atomicAdd(p, w);
  else if (op == kAddF)
    atomicAdd((double*)p, as_f64(w));
  else if (op == kMinF)
    atomic_min_f64(p, as_f64(w));
  else if (op == kMaxF)
    atomic_max_f64(p, as_f64(w));
  else if (op == kMinI)
    atomicMin((long long*)p, (long long)w);
  else
    atomicMax((long long*)p, (long long)w);
}

// one aggregate of a step's rows folded into a thread's table (`base` its
// slot of group 0), the fold known at compile time
template <int kOp>
__device__ __forceinline__ void fold_rows(unsigned long long* base, int T,
                                          const long long (&g)[kPairs][2],
                                          const bool (&ok)[kPairs][2],
                                          const long long (&r)[kPairs][2],
                                          bool one, bool conv) {
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[u][h]) continue;
      unsigned long long* p = base + g[u][h] * T;
      const unsigned long long w =
          one ? 1ULL : conv ? as_word((double)r[u][h])
                            : (unsigned long long)r[u][h];
      *p = fold(kOp, *p, w);
    }
  }
}

// The private branch: blockDim.x threads, W x blockDim.x words of shared
// memory; a thread folds rows 2q and 2q + 1 of pairs q0 + u T, u < kPairs,
// a step, the loads of kChunk aggregates at a time in flight.
template <bool kVec>
__global__ void __launch_bounds__(256)
    agg_private_kernel(AggArgs args, const long long* __restrict__ gid,
                       const bool* __restrict__ valid, long long n, int G,
                       int W, unsigned long long* __restrict__ partials,
                       int* __restrict__ ticket) {
  extern __shared__ unsigned long long tab[];
  const int T = blockDim.x, t = threadIdx.x, k = args.n_aggs;
  for (int s = 0; s < W; ++s) tab[s * T + t] = slot_ident(args, s / G);
  const long long pairs = (n + 1) >> 1, full = n >> 1;
  const long long step = (long long)gridDim.x * T * kPairs;
  for (long long q0 = (long long)blockIdx.x * T * kPairs + t; q0 < pairs;
       q0 += step) {
    // the step's pairs q0 + u T: every load first, then whether each row
    // counts (a full step of a vector kernel reads each pair with two
    // vector loads; the last step row by row)
    const bool fast = kVec && q0 + (long long)(kPairs - 1) * T < full;
    long long g[kPairs][2];
    unsigned char v[kPairs][2];
    if (fast) {
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const long long i = (q0 + (long long)u * T) << 1;
        const longlong2 gg = __ldg((const longlong2*)(gid + i));
        const uchar2 vv = __ldg((const uchar2*)(valid + i));
        g[u][0] = gg.x;
        g[u][1] = gg.y;
        v[u][0] = vv.x;
        v[u][1] = vv.y;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long i = ((q0 + (long long)u * T) << 1) + h;
          g[u][h] = i < n ? __ldg(gid + i) : -1;
          v[u][h] = i < n ? __ldg((const unsigned char*)valid + i) : 0;
        }
      }
    }
    bool ok[kPairs][2];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ok[u][h] = v[u][h] && g[u][h] >= 0 && g[u][h] < G;
        any = any || ok[u][h];
      }
    }
    if (!any) continue;
    for (int a0 = 0; a0 < k; a0 += kChunk) {
      // the loads of kChunk aggregates of every pair with a counted row
      long long r[kChunk][kPairs][2];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int a = a0 + j;
        const bool load = a < k && args.kind[a] != kCount;
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          r[j][u][0] = r[j][u][1] = 0;
          const long long i = (q0 + (long long)u * T) << 1;
          if (fast) {
            if (load && (ok[u][0] || ok[u][1]))
              load_raw2(args.in[a], args.dtype[a], i, r[j][u][0],
                        r[j][u][1]);
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (load && ok[u][h])
                r[j][u][h] = load_raw(args.in[a], args.dtype[a], i + h);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int a = a0 + j;
        if (a >= k) break;
        unsigned long long* base = tab + (long long)a * G * T + t;
        const bool one = args.kind[a] == kCount;
        const bool conv = args.op[a] == kAddF && args.dtype[a] != kF64;
        switch (args.op[a]) {
          case kAddI: fold_rows<kAddI>(base, T, g, ok, r[j], one, conv); break;
          case kAddF: fold_rows<kAddF>(base, T, g, ok, r[j], one, conv); break;
          case kMinI: fold_rows<kMinI>(base, T, g, ok, r[j], one, conv); break;
          case kMaxI: fold_rows<kMaxI>(base, T, g, ok, r[j], one, conv); break;
          case kMinF: fold_rows<kMinF>(base, T, g, ok, r[j], one, conv); break;
          default: fold_rows<kMaxF>(base, T, g, ok, r[j], one, conv);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ok[u][h]) tab[(long long)(k * G + g[u][h]) * T + t] += 1ULL;
    }
  }
  __syncthreads();
  // the block: its threads' tables (thread r's slot s at tab[s T + r])
  finish(args, G, W, tab, 1, T, T, partials, ticket);
}

// The block and global branches: one launch sets every output to its
// identity, a second folds the rows in with atomics.
__global__ void agg_init_kernel(AggArgs args, int G) {
  const long long W = (long long)(args.n_aggs + 1) * G;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < W;
       s += (long long)gridDim.x * blockDim.x)
    write_out(args, G, s, slot_ident(args, (int)(s / G)));
}

// w folded into output g of aggregate a (present at a = k) by an atomic;
// an int32 min/max output by a 32-bit one
__device__ __forceinline__ void fold_out(const AggArgs& args, int G, int a,
                                         long long g, unsigned long long w) {
  if (a < args.n_aggs && args.out32[a]) {
    int* p = (int*)args.out[a] + g;
    if (args.op[a] == kMinI)
      atomicMin(p, (int)(long long)w);
    else
      atomicMax(p, (int)(long long)w);
    return;
  }
  atomic_fold(slot_op(args, a), (unsigned long long*)args.out[a] + g, w);
}

// p with its address space hidden from the compiler, so that the atomics
// on the block's table are generic ones: on the H100 these ran faster
// than the shared-memory forms the compiler picks for a known address
__device__ __forceinline__ unsigned long long* generic(unsigned long long* p) {
  unsigned long long* q;
  asm volatile("mov.b64 %0, %1;" : "=l"(q) : "l"(p));
  return q;
}

// Each row folded by atomics into the block's table of W words in shared
// memory, then each slot that left its identity into the outputs by one
// global atomic (the block branch: kBlockTab); or each row straight into
// the outputs (the global branch).  A block table's slots fit an int, so
// its init and merge divide in 32 bits (64-bit divisions there cost a
// quarter to a third of the branch's time).
template <bool kBlockTab>
__global__ void __launch_bounds__(256)
    agg_atomic_kernel(AggArgs args, const long long* __restrict__ gid,
                      const bool* __restrict__ valid, long long n, int G) {
  extern __shared__ unsigned long long tab[];
  const int k = args.n_aggs;
  const int W = kBlockTab ? (k + 1) * G : 0;
  for (int s = threadIdx.x; s < W; s += blockDim.x)
    tab[s] = slot_ident(args, s / G);
  if (kBlockTab) __syncthreads();
  unsigned long long* acc = kBlockTab ? generic(tab) : nullptr;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!__ldg((const unsigned char*)valid + i)) continue;
    const long long g = __ldg(gid + i);
    if (g < 0 || g >= G) continue;
    for (int a = 0; a <= k; ++a) {
      const unsigned long long w =
          a == k || args.kind[a] == kCount
              ? 1ULL
              : to_word(args, a, load_raw(args.in[a], args.dtype[a], i));
      if (kBlockTab)
        atomic_fold(slot_op(args, a), acc + (long long)a * G + g, w);
      else
        fold_out(args, G, a, g, w);
    }
  }
  if (!kBlockTab) return;
  __syncthreads();
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int a = s / G;
    const unsigned long long v = tab[s];
    if (v != slot_ident(args, a)) fold_out(args, G, a, s - a * G, v);
  }
}

// The card's numbers the branches are sized by, read once a device: the
// first call on a device (behind a once flag, so concurrent first calls
// wait for it) also opts the private and block kernels into the card's
// whole shared-memory budget of a block, so the occupancy queries below
// hold for any table.
constexpr int kMaxDevices = 16;

struct Card {
  int dev = 0, sms = 0, smem_block = 0;
  cudaError_t err = cudaSuccess;
};

Card cards[kMaxDevices];
std::once_flag card_once[kMaxDevices];

cudaError_t card(Card* c) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(card_once[dev], [dev] {
    Card x;
    x.dev = dev;
    cudaError_t r =
        cudaDeviceGetAttribute(&x.sms, cudaDevAttrMultiProcessorCount, dev);
    if (r == cudaSuccess)
      r = cudaDeviceGetAttribute(
          &x.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const void* fns[3] = {(const void*)agg_private_kernel<true>,
                          (const void*)agg_private_kernel<false>,
                          (const void*)agg_atomic_kernel<true>};
    for (const void* fn : fns)
      if (r == cudaSuccess)
        r = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 x.smem_block - kStaticSmem);
    x.err = r;
    cards[dev] = x;
  });
  *c = cards[dev];
  return c->err;
}

// blocks of `fn` with `threads` threads and `smem` bytes of dynamic
// shared memory (beside kStaticSmem of static) an SM holds, by the
// card's occupancy rules (registers included)
int resident(const Card& c, const void* fn, int threads, long long smem) {
  int b = 0;
  if (smem + kStaticSmem > c.smem_block ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, threads,
                                                    (size_t)smem) !=
          cudaSuccess)
    return 0;
  return b;
}

// A table's branch, threads a block and resident blocks an SM, packed
// (1 + branch + 4 warps + 256 blocks) and kept for tables under
// kPlanWords words: the same for every call, so asked once.
constexpr int kPlanWords = 8192;
std::atomic<int> plan_cache[kMaxDevices][kPlanWords];

struct Plan {
  int branch, threads, blocks;
  size_t smem;
};

int table_plan(const Card& c, long long W) {
  std::atomic<int>* cached =
      W < kPlanWords ? &plan_cache[c.dev][W] : nullptr;
  if (cached) {
    const int known = cached->load(std::memory_order_relaxed);
    if (known) return known;
  }
  int packed = 1 + kGlobal + 4 * (otbt::kThreads / 32);
  // private: the thread count that keeps the most threads resident (on
  // a tie the larger)
  int best_t = 0, best_b = 0;
  for (int t = 256; t >= 64; t >>= 1) {
    const int b =
        resident(c, (const void*)agg_private_kernel<true>, t, W * t * 8);
    if (b * t > best_b * best_t) {
      best_t = t;
      best_b = b;
    }
  }
  if (best_b * best_t >= 32 * kMinPrivateWarps) {
    packed = 1 + kPrivate + 4 * (best_t / 32) + 256 * best_b;
  } else {
    // block: one table a block, while the tables leave kMinBlockWarps
    // resident warps an SM
    const int b =
        resident(c, (const void*)agg_atomic_kernel<true>, otbt::kThreads,
                 W * 8);
    if (b * otbt::kThreads >= 32 * kMinBlockWarps)
      packed = 1 + kBlock + 4 * (otbt::kThreads / 32);
  }
  if (cached) cached->store(packed, std::memory_order_relaxed);
  return packed;
}

cudaError_t plan_for(long long n, int G, int k, Plan* p) {
  Card c;
  cudaError_t e = card(&c);
  if (e != cudaSuccess) return e;
  const long long W = (long long)(k + 1) * G;
  const int packed = table_plan(c, W) - 1;
  p->branch = packed & 3;
  p->threads = ((packed >> 2) & 63) * 32;
  const long long cap = (long long)((packed >> 8) & 255) * c.sms;
  if (p->branch != kPrivate) {
    p->blocks = otbt::grid_for(n, 4);
    p->smem = p->branch == kBlock ? (size_t)(W * 8) : 0;
    return cudaSuccess;
  }
  const long long per_block = (long long)p->threads * kPairs;
  const long long want = ((n + 1) / 2 + per_block - 1) / per_block;
  p->smem = (size_t)(W * p->threads * 8);
  p->blocks = (int)(want < 1 ? 1 : want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace

// Bytes of otbt_grouped_agg_dense's scratch for n rows into num_groups
// slots with n_aggs aggregates: the blocks' and the block groups' partials
// (W words each) and a ticket a group and one more, when more than one
// block of the private branch folds; 0 for one block and on the block and
// global branches; -1 when the card cannot be read.
extern "C" long long otbt_grouped_agg_dense_scratch_bytes(long long n,
                                                          int num_groups,
                                                          int n_aggs) {
  if (n < 0 || num_groups < 1 || n_aggs < 0 || n_aggs > kMaxAggs) return -1;
  Plan p;
  if (plan_for(n, num_groups, n_aggs, &p) != cudaSuccess) return -1;
  if (p.branch != kPrivate || p.blocks == 1) return 0;
  const long long groups = (p.blocks + kGroupBlocks - 1) / kGroupBlocks;
  return (p.blocks + groups) * (n_aggs + 1) * num_groups * 8 +
         4 * (groups + 1);
}

// Which branch a call takes: 0 private, 1 block, 2 global (-1 on a bad
// argument or when the card cannot be read).
extern "C" int otbt_grouped_agg_dense_branch(long long n, int num_groups,
                                             int n_aggs) {
  if (n < 0 || num_groups < 1 || n_aggs < 0 || n_aggs > kMaxAggs) return -1;
  Plan p;
  if (plan_for(n, num_groups, n_aggs, &p) != cudaSuccess) return -1;
  return p.branch;
}

// gid: n int64; valid: n bools; in_ptrs / kinds / dtypes / idents: HOST
// arrays of n_aggs entries; out: (n_aggs + 1) regions of num_groups
// 8-byte words, the aggregates then present (an int32 output, min/max
// over int32, fills the first half of its region); scratch:
// otbt_grouped_agg_dense_scratch_bytes bytes, 8-byte aligned.  Private
// branch: one launch, plus one memset of the tickets when more than one
// block folds; block and global branches: two launches.
extern "C" int otbt_grouped_agg_dense(const void* gid, const void* valid,
                                      long long n, int num_groups, int n_aggs,
                                      const long long* in_ptrs,
                                      const int* kinds, const int* dtypes,
                                      const long long* idents, void* out,
                                      void* scratch, long long scratch_bytes,
                                      void* stream) {
  if (n < 0 || n_aggs < 0 || n_aggs > kMaxAggs || num_groups <= 0 ||
      scratch_bytes < otbt_grouped_agg_dense_scratch_bytes(n, num_groups,
                                                           n_aggs))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int G = num_groups;
  AggArgs args;
  args.n_aggs = n_aggs;
  bool vec = ((unsigned long long)gid & 15ull) == 0 &&
             ((unsigned long long)valid & 1ull) == 0;
  for (int a = 0; a < kMaxAggs; ++a) {
    const bool live = a < n_aggs;
    const int kind = live ? kinds[a] : 0, dt = live ? dtypes[a] : 0;
    args.kind[a] = kind;
    args.dtype[a] = dt;
    args.ident[a] = live ? idents[a] : 0;
    args.in[a] = live ? (const void*)in_ptrs[a] : nullptr;
    args.out[a] = live ? (char*)out + (size_t)a * G * 8 : nullptr;
    int op = kAddI;
    if (kind == kSumFloat) op = kAddF;
    if (kind == kMin) op = dt == kF64 ? kMinF : kMinI;
    if (kind == kMax) op = dt == kF64 ? kMaxF : kMaxI;
    args.op[a] = op;
    args.out32[a] = live && (kind == kMin || kind == kMax) && dt == kI32;
    if (live && kind != kCount) {
      const unsigned long long align = dt == kBool ? 2 : dt == kI32 ? 8 : 16;
      vec = vec && ((unsigned long long)in_ptrs[a] % align) == 0;
    }
  }
  args.out[n_aggs] = (char*)out + (size_t)n_aggs * G * 8;
  Plan p;
  cudaError_t e = plan_for(n, G, n_aggs, &p);
  if (e != cudaSuccess) return (int)e;
  const long long W = (long long)(n_aggs + 1) * G;
  const long long* g = (const long long*)gid;
  const bool* v = (const bool*)valid;
  if (p.branch != kPrivate) {
    agg_init_kernel<<<otbt::grid_for(W), otbt::kThreads, 0, st>>>(args, G);
    if (n > 0 && p.branch == kBlock)
      agg_atomic_kernel<true><<<p.blocks, p.threads, p.smem, st>>>(
          args, g, v, n, G);
    else if (n > 0)
      agg_atomic_kernel<false><<<p.blocks, p.threads, 0, st>>>(
          args, g, v, n, G);
    return (int)cudaGetLastError();
  }
  unsigned long long* partials = nullptr;
  int* ticket = nullptr;
  if (p.blocks > 1) {
    const int groups = (p.blocks + kGroupBlocks - 1) / kGroupBlocks;
    partials = (unsigned long long*)scratch;
    ticket = (int*)(partials + (long long)(p.blocks + groups) * W);
    e = cudaMemsetAsync(ticket, 0, sizeof(int) * (groups + 1), st);
    if (e != cudaSuccess) return (int)e;
  }
  if (vec)
    agg_private_kernel<true><<<p.blocks, p.threads, p.smem, st>>>(
        args, g, v, n, G, (int)W, partials, ticket);
  else
    agg_private_kernel<false><<<p.blocks, p.threads, p.smem, st>>>(
        args, g, v, n, G, (int)W, partials, ticket);
  return (int)cudaGetLastError();
}
