// Lexicographic multi-key sort, as a permutation: a stable LSD radix sort.
//
// Replaces opentenbase_tpu/ops/kernels.py:488 sort_rows (jax.lax.sort
// over [~valid, keys..., payload..., valid]).  The wrapper turns every
// key into one int64 order word (ops/kernels.py order_words), so this
// sort orders [w, n] int64 word rows lexicographically, with the row
// index as the last tie-break: the stable order of the reference.
//
// Words are taken from the last to the first and, within a word, 8-bit
// digits from the low to the high; every pass is a stable counting pass,
// so the result is the lexicographic order with ties in row order.  A
// word's sort key is (uint64)(x - min(word)), which orders as x does for
// any int64 span, so the digits above the span's top bit are constant.
//
// Bound: bytes.  An active pass reads the keys twice and the row
// indices once and writes both, 40 bytes a row; the words are read once
// for their min and max and twice by each word's first pass.  What the design
// does about it:
// - Digit skipping on the device.  sort_stats takes each word's min and
//   max; no pass runs for a digit above the span's top bit, so a ~valid
//   word with every row valid, K5's zero words and the high digits of
//   narrow keys cost nothing.  A digit below it whose histogram (the
//   pass's own tile counts, summed) puts all n rows in one bucket skips
//   its scatter and keeps the buffer parity.  The top digit of a word
//   that is not constant always varies, so the last pass is known from
//   the spans alone and writes the output directly.
// - No host read and a fixed launch sequence for a given (n, w): three
//   launches (sort_init, sort_stats, sort_passes), so the fused and
//   cluster programs capture the sort into CUDA graphs; the plan (which
//   passes, which buffer each reads) is derived inside the call from the
//   spans and the histograms, the same in every block, so a replay
//   starts from its own inputs' plan.
// - The passes run in one cooperative launch (every block resident):
//   each active pass is reduce-then-scan, three phases between grid
//   barriers: each block's digit counts over its tiles; a scan over
//   the blocks for every digit, one warp a digit; and a scatter that
//   recomputes each row's stable rank in its tile in shared memory
//   (__match_any_sync within a warp, then warps in order), stages the
//   tile in digit order in shared memory and writes each digit's run
//   contiguously.  A word's first pass reads it through the current
//   order (in row order before any pass) in both phases, so the keys
//   are first written by a scatter.  A skipped pass is a branch, not a
//   launch.
// - n <= kSmallMax rows: one block sorts in shared memory in one launch
//   (the same ranking; constant digits found from the OR and AND of the
//   keys), since most calls on the TPC-H paths sort a few groups.
// Offsets are 64-bit throughout: n reaches 2^22 and beyond.
#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kRadix = 256;
constexpr int kDigits = 8;
constexpr int kNoDigit = kRadix;       // a lane without a row
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
// tiles of 256 x 8 rows, two blocks an SM; from kWideMin rows on,
// 256 x 16 rows, one block an SM (measured faster there on the H100)
constexpr long long kWideMin = 1LL << 19;
constexpr int kStatBlocks = 264;       // two per SM of an H100
constexpr int kSmallThreads = 1024;
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSmallItems = 4;
constexpr long long kSmallMax = (long long)kSmallThreads * kSmallItems;
constexpr long long kI64Max = 0x7fffffffffffffffLL;
constexpr long long kI64Min = (long long)(1ULL << 63);

// Scratch of the multi-block path, carved from one buffer (offsets in
// bytes, each 256-aligned):
//   keys   2 x n uint64     the ping-pong sort keys
//   perm   2 x n int64      the ping-pong row indices
//   cols   G x 256 int64    each block's digit sums, scanned over blocks
//   tot    256 int64        each digit's count (the pass's histogram)
//   mm     2 w int64        each word's min, then its max
//   bar    1 uint32         the passes kernel's grid barrier
struct Layout {
  long long keys, perm, cols, tot, mm, bar, total, T;
};

inline long long align256(long long b) { return (b + 255) & ~255LL; }

inline Layout layout(int w, long long n, long long tile, long long G) {
  Layout L;
  L.T = (n + tile - 1) / tile;
  long long off = 0;
  L.keys = off;  off += align256(16 * n);
  L.perm = off;  off += align256(16 * n);
  L.cols = off;  off += align256(8LL * kRadix * G);
  L.tot = off;   off += align256(8LL * kRadix);
  L.mm = off;    off += align256(16LL * (w > 0 ? w : 1));
  L.bar = off;   off += 256;
  L.total = off;
  return L;
}

// Digits of a key below the top bit of span (0 for a constant word).
__device__ __forceinline__ int span_digits(u64 span) {
  return span == 0 ? 0 : (63 - __clzll((long long)span)) / 8 + 1;
}

__global__ void sort_init(int w, long long* __restrict__ mm,
                          unsigned* __restrict__ bar) {
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    mm[c] = kI64Max;
    mm[w + c] = kI64Min;
  }
  if (threadIdx.x == 0) *bar = 0;
}

// mm[c] = min of word c, mm[w + c] = its max: a block reduction, then
// one atomic per block.
__global__ void sort_stats(const long long* __restrict__ words, int w,
                           long long n, long long* __restrict__ mm) {
  __shared__ long long red[2][kTileWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (int c = 0; c < w; ++c) {
    const long long* x = words + (long long)c * n;
    long long mn = kI64Max, mx = kI64Min;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      long long v = x[i];
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
    }
    for (int off = 16; off > 0; off >>= 1) {
      long long a = __shfl_down_sync(0xffffffffu, mn, off);
      long long b = __shfl_down_sync(0xffffffffu, mx, off);
      mn = a < mn ? a : mn;
      mx = b > mx ? b : mx;
    }
    if (lane == 0) {
      red[0][warp] = mn;
      red[1][warp] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int g = 1; g < kTileWarps; ++g) {
        mn = red[0][g] < mn ? red[0][g] : mn;
        mx = red[1][g] > mx ? red[1][g] : mx;
      }
      atomicMin(mm + c, mn);
      atomicMax(mm + w + c, mx);
    }
    __syncthreads();
  }
}

// The stable rank of each item among the block's items with the same
// digit.  Warp g owns rows [g * 32 * ITEMS, (g + 1) * 32 * ITEMS) of the
// block's rows, item j of lane l being row g * 32 * ITEMS + 32 j + l, so
// a warp's items are in row order item by item, lane by lane.  wc:
// WARPS x kRadix shared counters; tot (may be null): each digit's count.
// All threads of the block call it; it begins and ends with a barrier.
template <int WARPS, int ITEMS>
__device__ __forceinline__ void rank_items(const int (&dig)[ITEMS],
                                           unsigned (&loc)[ITEMS],
                                           unsigned* wc, unsigned* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < WARPS * kRadix; i += blockDim.x) wc[i] = 0;
  __syncthreads();
  unsigned* mine = wc + warp * kRadix;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int dg = dig[j];
    unsigned peers = __match_any_sync(0xffffffffu, dg);
    int leader = __ffs(peers) - 1;
    unsigned base = 0;
    if (lane == leader && dg < kRadix) {
      base = mine[dg];
      mine[dg] = base + __popc(peers);
    }
    base = __shfl_sync(0xffffffffu, base, leader);
    loc[j] = base + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();
  // warps in order: each (warp, digit) counter becomes the count of the
  // digit in the warps before it
  for (int dg = threadIdx.x; dg < kRadix; dg += blockDim.x) {
    unsigned run = 0;
    for (int g = 0; g < WARPS; ++g) {
      unsigned c = wc[g * kRadix + dg];
      wc[g * kRadix + dg] = run;
      run += c;
    }
    if (tot != nullptr) tot[dg] = run;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (dig[j] < kRadix) loc[j] += mine[dig[j]];
}

// Every block of the cooperative launch arrives, then leaves once all
// have arrived.  *epoch counts this block's barriers x the grid size.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned* epoch) {
  __syncthreads();
  *epoch += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*(volatile unsigned*)bar < *epoch) __nanosleep(20);
    __threadfence();
  }
  __syncthreads();
}

// Exclusive scan of one value per thread of a kTileThreads block; *total
// gets the block's sum.  ws: kTileWarps scratch.  Begins and ends with
// a barrier's worth of ordering for ws.
__device__ __forceinline__ long long block_scan(long long v, long long* ws,
                                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    long long o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  long long before = 0, all = 0;
  for (int g = 0; g < kTileWarps; ++g) {
    long long x = ws[g];
    before += g < warp ? x : 0;
    all += x;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

template <int ITEMS>
struct PassSmem {
  static constexpr long long kTile = (long long)kTileThreads * ITEMS;
  u64 keys[kTile];                   // the tile in digit order
  long long perm[kTile];
  unsigned wc[kTileWarps * kRadix];  // rank_items' counters
  unsigned cnt[kRadix];              // a tile's digit counts
  long long run[kRadix];             // next output position per digit
  long long start[kRadix];           // the tile's digit runs in keys[]
  long long bsum[kRadix];            // this block's digit sums
  long long ws[kTileWarps];
  int skip;
};

// All passes, in one cooperative launch of G blocks; block g takes the
// tiles [g * tb, (g + 1) * tb).  Every block derives the same plan from
// the spans and the histograms, so every block meets the same barriers.
template <int ITEMS, int MINB>
__global__ void __launch_bounds__(kTileThreads, MINB)
sort_passes(const long long* __restrict__ words, int w, long long n,
            long long T, long long tb, const long long* __restrict__ mm,
            u64* __restrict__ keys, long long* __restrict__ perm,
            long long* __restrict__ cols,
            long long* __restrict__ tot, unsigned* __restrict__ bar,
            long long* __restrict__ out_perm,
            long long* __restrict__ out_first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr long long kTile = PassSmem<ITEMS>::kTile;
  PassSmem<ITEMS>& sm = *reinterpret_cast<PassSmem<ITEMS>*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long t_lo = blockIdx.x * tb;
  const long long t_hi = t_lo + tb < T ? t_lo + tb : T;
  unsigned epoch = 0;
  // the last pass: the top digit of the last word (in processing order)
  // that is not constant
  int last_s = -1, last_d = -1;
  for (int s = 0; s < w; ++s) {
    int c = w - 1 - s;
    int nd = span_digits((u64)mm[w + c] - (u64)mm[c]);
    if (nd > 0) {
      last_s = s;
      last_d = nd - 1;
    }
  }
  int b = 0;              // the buffer holding the current order
  bool ordered = false;   // a pass has scattered: perm[b] holds the order
  for (int s = 0; s < w; ++s) {
    const int c = w - 1 - s;
    const long long* x = words + (long long)c * n;
    const u64 mn = (u64)mm[c];
    const int nd = span_digits((u64)mm[w + c] - mn);
    bool in_kb = false;   // keys[b] holds this word's keys
    for (int d = 0; d < nd; ++d) {
      const u64* kb = keys + (long long)b * n;
      const long long* pb = perm + (long long)b * n;
      // row i's key and row index: from the buffers once a pass of this
      // word has scattered, else the word gathered through the current
      // order (read in row order before any pass)
      const int mode = in_kb ? 0 : (ordered ? 1 : 2);
      auto load = [&](long long i, u64& key, long long& pv) {
        if (mode == 0) {
          key = kb[i];
          pv = pb[i];
        } else {
          pv = mode == 1 ? pb[i] : i;
          key = (u64)x[pv] - mn;
        }
      };
      // 1. the block's digit sums
      sm.bsum[tid] = 0;
      for (long long t = t_lo; t < t_hi; ++t) {
        sm.cnt[tid] = 0;
        __syncthreads();
        const long long i0 = t * kTile + tid;
        u64 kv[ITEMS];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          long long i = i0 + (long long)j * kTileThreads;
          long long pv;
          if (i < n) load(i, kv[j], pv);
        }
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
          if (i0 + (long long)j * kTileThreads < n)
            atomicAdd(sm.cnt + (int)((kv[j] >> (8 * d)) & 0xff), 1u);
        __syncthreads();
        sm.bsum[tid] += sm.cnt[tid];
      }
      cols[(long long)blockIdx.x * kRadix + tid] = sm.bsum[tid];
      grid_barrier(bar, &epoch);
      // 2. each digit's block sums, scanned over blocks by one warp; the
      //    total is the digit's count
      for (int dg = blockIdx.x * kTileWarps + warp; dg < kRadix;
           dg += gridDim.x * kTileWarps) {
        long long carry = 0;
        for (unsigned g0 = 0; g0 < gridDim.x; g0 += 32) {
          unsigned g = g0 + lane;
          long long v = g < gridDim.x ? cols[(long long)g * kRadix + dg] : 0;
          long long incl = v;
          for (int off = 1; off < 32; off <<= 1) {
            long long o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
          }
          if (g < gridDim.x) cols[(long long)g * kRadix + dg] = carry + incl - v;
          carry += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (lane == 0) tot[dg] = carry;
      }
      grid_barrier(bar, &epoch);
      // 3. a digit holding all n rows leaves the order as it is (never
      //    the top digit, so never the last pass); else scatter
      long long cnt_d = tot[tid];
      if (tid == 0) sm.skip = 0;
      __syncthreads();
      if (cnt_d == n) sm.skip = 1;
      long long all;
      long long base = block_scan(cnt_d, sm.ws, &all);
      if (sm.skip) continue;               // block-uniform
      const bool fin = s == last_s && d == last_d;
      const bool write_first = fin && out_first != nullptr && c == 0;
      u64* kd = keys + (long long)(1 - b) * n;
      long long* pd = perm + (long long)(1 - b) * n;
      sm.run[tid] = base + cols[(long long)blockIdx.x * kRadix + tid];
      for (long long t = t_lo; t < t_hi; ++t) {
        const long long lo = t * kTile;
        const long long i0 = lo + (long long)warp * 32 * ITEMS + lane;
        u64 key[ITEMS];
        long long pv[ITEMS];
        int dig[ITEMS];
        unsigned loc[ITEMS];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          long long i = i0 + 32LL * j;
          bool in = i < n;
          key[j] = 0;
          pv[j] = 0;
          if (in) load(i, key[j], pv[j]);
          dig[j] = in ? (int)((key[j] >> (8 * d)) & 0xff) : kNoDigit;
        }
        rank_items<kTileWarps, ITEMS>(dig, loc, sm.wc, sm.cnt);
        long long rows_t;
        sm.start[tid] = block_scan(sm.cnt[tid], sm.ws, &rows_t);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          if (dig[j] >= kRadix) continue;
          long long lp = sm.start[dig[j]] + loc[j];
          sm.keys[lp] = key[j];
          sm.perm[lp] = pv[j];
        }
        __syncthreads();
        // the tile in digit order: each digit's run goes to consecutive
        // output positions
        for (int r = tid; r < rows_t; r += kTileThreads) {
          u64 k = sm.keys[r];
          int dg = (int)((k >> (8 * d)) & 0xff);
          long long pos = sm.run[dg] + (r - sm.start[dg]);
          if (fin) {
            out_perm[pos] = sm.perm[r];
            if (write_first) out_first[pos] = (long long)(k + mn);
          } else {
            kd[pos] = k;
            pd[pos] = sm.perm[r];
          }
        }
        __syncthreads();
        sm.run[tid] += sm.cnt[tid];
        __syncthreads();
      }
      if (!fin) grid_barrier(bar, &epoch);
      b = 1 - b;
      ordered = true;
      in_kb = true;
    }
  }
  // no pass ran: the identity order; the last pass outside word 0:
  // word 0 is constant (its minimum)
  const bool none = last_s < 0;
  const bool fill = !none && out_first != nullptr && last_s != w - 1;
  if (!none && !fill) return;
  const long long mn0 = w > 0 ? mm[0] : 0;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + tid; i < n;
       i += stride) {
    if (none) {
      out_perm[i] = i;
      if (out_first != nullptr) out_first[i] = words[i];
    } else {
      out_first[i] = mn0;
    }
  }
}

// Block-wide reductions of the small path (kSmallThreads threads).
__device__ __forceinline__ long long block_min(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1) {
    long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int g = 1; g < kSmallWarps; ++g) v = red[g] < v ? red[g] : v;
  __syncthreads();
  return v;
}

__device__ __forceinline__ u64 block_varying(u64 o, u64 a, u64* red) {
  for (int off = 16; off > 0; off >>= 1) {
    o |= __shfl_xor_sync(0xffffffffu, o, off);
    a &= __shfl_xor_sync(0xffffffffu, a, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[2 * warp] = o;
    red[2 * warp + 1] = a;
  }
  __syncthreads();
  o = 0;
  a = ~0ULL;
  for (int g = 0; g < kSmallWarps; ++g) {
    o |= red[2 * g];
    a &= red[2 * g + 1];
  }
  __syncthreads();
  return o ^ a;
}

// Exclusive scan of tot[0, kRadix) into base (threads < kRadix; all
// threads call it).
__device__ __forceinline__ void digit_bases(const unsigned* tot,
                                            unsigned* base,
                                            unsigned* warp_sums) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned v = t < kRadix ? tot[t] : 0, incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    unsigned o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (t < kRadix && lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (t < kRadix) {
    unsigned before = 0;
    for (int g = 0; g < warp; ++g) before += warp_sums[g];
    base[t] = before + incl - v;
  }
  __syncthreads();
}

constexpr size_t kSmallSmem =
    kSmallMax * 8 + kSmallMax * 4 +                // keys, perm
    (size_t)kSmallWarps * kRadix * 4 +             // rank counters
    2 * kRadix * 4 +                               // tot, base
    2 * kSmallWarps * 8 + 8 * 4;                   // reductions, warp sums

// n <= kSmallMax: the whole sort in one block.  Row r of item j of
// thread (warp g, lane l) is g * 32 * kSmallItems + 32 j + l.
__global__ void __launch_bounds__(kSmallThreads)
sort_small(const long long* __restrict__ words, int w, long long n,
           long long* __restrict__ out_perm,
           long long* __restrict__ out_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* k_sh = (u64*)smem;
  unsigned* p_sh = (unsigned*)(k_sh + kSmallMax);
  unsigned* wc = p_sh + kSmallMax;
  unsigned* tot = wc + kSmallWarps * kRadix;
  unsigned* base = tot + kRadix;
  u64* red = (u64*)(base + kRadix);
  unsigned* warp_sums = (unsigned*)(red + 2 * kSmallWarps);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int row[kSmallItems];
  u64 key[kSmallItems];
  unsigned pv[kSmallItems];
#pragma unroll
  for (int j = 0; j < kSmallItems; ++j) {
    row[j] = warp * 32 * kSmallItems + 32 * j + lane;
    pv[j] = (unsigned)row[j];
    key[j] = 0;
    if (row[j] < n) p_sh[row[j]] = pv[j];
  }
  __syncthreads();
  u64 mn = 0;
  for (int s = 0; s < w; ++s) {
    const long long* x = words + (long long)(w - 1 - s) * n;
    long long xv[kSmallItems];
    long long lmin = kI64Max;
#pragma unroll
    for (int j = 0; j < kSmallItems; ++j) {
      bool in = row[j] < n;
      xv[j] = in ? x[pv[j]] : kI64Max;
      lmin = xv[j] < lmin ? xv[j] : lmin;
    }
    mn = (u64)block_min(lmin, (long long*)red);
    u64 o = 0, a = ~0ULL;
#pragma unroll
    for (int j = 0; j < kSmallItems; ++j) {
      key[j] = (u64)xv[j] - mn;
      if (row[j] < n) {
        o |= key[j];
        a &= key[j];
      }
    }
    const u64 varying = block_varying(o, a, red);
    for (int d = 0; d < kDigits; ++d) {
      if (((varying >> (8 * d)) & 0xff) == 0) continue;   // block-uniform
      int dig[kSmallItems];
      unsigned loc[kSmallItems];
#pragma unroll
      for (int j = 0; j < kSmallItems; ++j)
        dig[j] = row[j] < n ? (int)((key[j] >> (8 * d)) & 0xff) : kNoDigit;
      rank_items<kSmallWarps, kSmallItems>(dig, loc, wc, tot);
      digit_bases(tot, base, warp_sums);
#pragma unroll
      for (int j = 0; j < kSmallItems; ++j) {
        if (dig[j] >= kRadix) continue;
        unsigned pos = base[dig[j]] + loc[j];
        k_sh[pos] = key[j];
        p_sh[pos] = pv[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kSmallItems; ++j) {
        if (row[j] >= n) continue;
        key[j] = k_sh[row[j]];
        pv[j] = p_sh[row[j]];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSmallItems; ++j) {
    if (row[j] >= n) continue;
    out_perm[row[j]] = pv[j];
    if (out_first != nullptr) out_first[row[j]] = (long long)(key[j] + mn);
  }
}

}  // namespace

// The passes kernel for n rows and its grid: at most the blocks the card
// holds resident at once (grid barriers), at most one per tile.
struct Passes {
  const void* fn;
  long long tile, G;
  size_t smem;
};

template <int ITEMS, int MINB>
static int passes_for(long long n, Passes* p) {
  static int resident = 0;
  const size_t smem = sizeof(PassSmem<ITEMS>);
  if (resident == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t e = cudaFuncSetAttribute(
        sort_passes<ITEMS, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sort_passes<ITEMS, MINB>, kTileThreads, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  p->fn = (const void*)sort_passes<ITEMS, MINB>;
  p->tile = PassSmem<ITEMS>::kTile;
  p->smem = smem;
  long long T = (n + p->tile - 1) / p->tile;
  long long G = T < resident ? T : resident;
  long long tb = (T + G - 1) / G;
  p->G = (T + tb - 1) / tb;
  return 0;
}

static int passes_of(long long n, Passes* p) {
  return n < kWideMin ? passes_for<8, 2>(n, p) : passes_for<16, 1>(n, p);
}

// Bytes of scratch otbt_sort_perm needs for n rows of w words (0: the
// one-block path needs none; -1: the card could not be queried).
extern "C" long long otbt_sort_scratch_bytes(int w, long long n) {
  if (n <= kSmallMax) return 0;
  Passes p;
  return passes_of(n, &p) ? -1 : layout(w, n, p.tile, p.G).total;
}

// words: w x n int64 (row-major by word); scratch: otbt_sort_scratch_bytes
// (w, n) bytes; perm: n int64, the sorted order; first (may be null, needs
// w >= 1): n int64, word 0 in sorted order.
extern "C" int otbt_sort_perm(const void* words, int w, long long n,
                              void* scratch, long long scratch_bytes,
                              void* perm, void* first, void* stream) {
  if (w < 0 || n < 0 || (first != nullptr && w < 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* x = (const long long*)words;
  long long* out = (long long*)perm;
  long long* out_first = (long long*)first;
  if (n <= kSmallMax) {
    static bool smem_set = false;
    if (!smem_set) {
      cudaError_t e = cudaFuncSetAttribute(
          sort_small, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kSmallSmem);
      if (e != cudaSuccess) return (int)e;
      smem_set = true;
    }
    sort_small<<<1, kSmallThreads, kSmallSmem, st>>>(x, w, n, out,
                                                     out_first);
    return (int)cudaGetLastError();
  }
  Passes ps;
  int err = passes_of(n, &ps);
  if (err) return err;
  long long G = ps.G;
  Layout L = layout(w, n, ps.tile, G);
  if (scratch == nullptr || scratch_bytes < L.total)
    return (int)cudaErrorInvalidValue;
  unsigned char* sb = (unsigned char*)scratch;
  u64* keys = (u64*)(sb + L.keys);
  long long* pm = (long long*)(sb + L.perm);
  long long* cols = (long long*)(sb + L.cols);
  long long* tot = (long long*)(sb + L.tot);
  long long* mm = (long long*)(sb + L.mm);
  unsigned* bar = (unsigned*)(sb + L.bar);
  const int gs = (int)((n + kTileThreads - 1) / kTileThreads < kStatBlocks
                           ? (n + kTileThreads - 1) / kTileThreads
                           : kStatBlocks);
  sort_init<<<1, kTileThreads, 0, st>>>(w, mm, bar);
  sort_stats<<<gs, kTileThreads, 0, st>>>(x, w, n, mm);
  long long T = L.T;
  long long tb = (T + G - 1) / G;
  void* args[] = {(void*)&x,    (void*)&w,     (void*)&n,   (void*)&T,
                  (void*)&tb,   (void*)&mm,    (void*)&keys, (void*)&pm,
                  (void*)&cols, (void*)&tot,   (void*)&bar,
                  (void*)&out,  (void*)&out_first};
  cudaError_t e = cudaLaunchCooperativeKernel(ps.fn, (unsigned)G,
                                              kTileThreads, args, ps.smem,
                                              st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
