// K12: the exchange of the cluster tier, N logical DataNodes on one card.
//
// Replaces opentenbase_tpu/exec/mesh_exec.py:610 _a2a_batch (a slot per
// row by one cumsum per destination, a pack into ndn x bucket buffers,
// then all_to_all), :673 _broadcast_batch (all_gather) and
// parallel/mesh.py:72 _pack_for_a2a / :97 redistribute.  On one card
// the collective is a stable partition: each source (a DataNode's
// batch) brings its own columns, valid mask and destinations (K11's
// route kernel, or destination 0 for every live row in the broadcast /
// gather form), read in place; the sources count as one row space in
// source order (source s owns global rows [off[s], off[s+1])), and
// destination d receives its live rows in source order, then in row
// order, packed into rows [d * region, d * region + R_d) of each output
// column.  That is the order of the valid rows of the reference's
// all_to_all buckets.  Dead rows (not valid, or destination out of
// range) are dropped, so the exchange also compacts.
//
// Two forms.  The sized form (otbt_exchange_count, then
// otbt_exchange_scatter, the eager tier) lets the host read the count
// matrix once and size each destination's region to fit:
// (a) xchg_tile_counts: per (source, 1024-row tile), a shared-memory
//     histogram of destinations;
// (b) xchg_tile_scan: one block per destination scans the tile counts
//     in (source, tile) order (scan.cuh's block scan) into each tile's
//     base offset, and writes the ndn_src x ndn_dst count matrix;
// (c) xchg_positions: each tile again, in four rounds of 256 rows; a
//     row's rank among its tile's rows bound for the same destination
//     comes from warp ballots and the per-warp totals, so every live
//     row gets its output slot (and the output valid mask its bit);
// (d) rows.cuh's scatter moves every column and null mask of one
//     source, up to 16 columns of mixed widths a launch.
// Bound: bytes (destinations and the valid mask read twice, each column
// read once and written once for its live rows).
//
// The fixed-capacity form (otbt_exchange_fixed, the reference's static
// all_to_all buckets, the cluster program's) takes the region from the
// caller and reads nothing back: a row whose slot falls beyond its
// destination's region is dropped and counted in that destination's
// overflow.  It is one memset of look-back control words and one launch
// of xchg_fixed_tiles.  Every source's 4096-row tiles form one tile
// space in (source, tile) order, taken from an atomic ticket.  A tile
// reads its destinations and valid bytes once (16-byte loads), keeps a
// one-byte destination code a row in shared memory, and ranks each row
// among the tile's rows bound for the same destination with
// __match_any_sync and per-warp running counts, so a row costs the same
// whatever the number of destinations.  Each destination has its own
// decoupled look-back chain (lookback.cuh), run by the block's warps, a
// destination each in turn: the tile publishes its count for every
// destination and takes its exclusive base, then writes each live row
// that fits, every column and its valid byte, to d * region + base_d +
// rank.  No slot array goes to device memory and nothing is read
// twice.  Blocks after the last tile wait for every source's last tile
// (whose inclusive prefixes they read) and write the count matrix, the
// totals, the overflow and the false tail of each region of the valid
// mask.  A launch moves up to 64 columns of 1, 2, 4 or 8 bytes (fewer
// where (sources + 1) x columns would pass the parameters' 248
// pointers: 49 at 4 sources, 11 at 20); columns beyond go in one more
// launch a set, which ranks the tiles again and takes their bases from
// the first launch.  Bound: bytes (destinations
// and valid bytes read once, each moved row's columns read and written
// once, the valid mask written once).
#include "lookback.cuh"
#include "rows.cuh"
#include "scan.cuh"

namespace {

constexpr int kMaxDn = 64;
constexpr int kTile = 1024;
constexpr int kRounds = kTile / otbt::kScanThreads;   // 4 rounds of 256
constexpr int kWarps = otbt::kScanThreads / 32;

struct Segs {
  int n;                       // sources
  long long off[kMaxDn + 1];   // source s owns global rows [off[s], off[s+1])
  const int* dest[kMaxDn];     // source s's destinations, or nullptr
  const bool* valid[kMaxDn];   // source s's valid mask
};

// Destination of row i, or ndst when the row is dead.
__device__ __forceinline__ int dest_of(const int* __restrict__ dest,
                                       const bool* __restrict__ valid,
                                       long long i, int ndst) {
  if (!valid[i]) return ndst;
  int d = dest != nullptr ? dest[i] : 0;
  return (d >= 0 && d < ndst) ? d : ndst;
}

__global__ void xchg_tile_counts(Segs segs, int ndst, long long tiles,
                                 long long* __restrict__ tile_counts) {
  __shared__ unsigned int cnt[kMaxDn];
  const int s = blockIdx.y;
  const long long t = blockIdx.x;
  for (int d = threadIdx.x; d < ndst; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  const long long rows = segs.off[s + 1] - segs.off[s];
  long long lo = t * kTile;
  long long hi = lo + kTile < rows ? lo + kTile : rows;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    int d = dest_of(segs.dest[s], segs.valid[s], i, ndst);
    if (d < ndst) atomicAdd(&cnt[d], 1u);
  }
  __syncthreads();
  long long base = ((long long)s * tiles + t) * ndst;
  for (int d = threadIdx.x; d < ndst; d += blockDim.x)
    tile_counts[base + d] = cnt[d];
}

// One block per destination d.  tile_base[(s, t), d] = rows bound for d
// in all earlier (source, tile) pairs; counts[s, d] = rows of source s
// bound for d.
__global__ void xchg_tile_scan(const long long* __restrict__ tile_counts,
                               int nsrc, int ndst, long long tiles,
                               long long* __restrict__ tile_base,
                               long long* __restrict__ counts) {
  __shared__ long long sh[otbt::kScanThreads];
  const int d = blockIdx.x;
  const long long total_tiles = (long long)nsrc * tiles;
  long long carry = 0;
  for (long long b = 0; b < total_tiles; b += otbt::kScanThreads) {
    long long f = b + threadIdx.x;
    long long v = f < total_tiles ? tile_counts[f * ndst + d] : 0;
    long long chunk;
    long long ex = otbt::block_exclusive(v, sh, &chunk);
    if (f < total_tiles) tile_base[f * ndst + d] = carry + ex;
    carry += chunk;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < nsrc; s += blockDim.x) {
    long long start = tile_base[((long long)s * tiles) * ndst + d];
    long long end = s + 1 < nsrc
                        ? tile_base[((long long)(s + 1) * tiles) * ndst + d]
                        : carry;
    counts[(long long)s * ndst + d] = end - start;
  }
}

__global__ void xchg_positions(Segs segs, int ndst, long long tiles,
                               const long long* __restrict__ tile_base,
                               long long region, long long* __restrict__ pos,
                               bool* __restrict__ out_valid) {
  __shared__ unsigned int warp_cnt[kWarps][kMaxDn];
  __shared__ long long run[kMaxDn];
  const int s = blockIdx.y;
  const long long t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long rows = segs.off[s + 1] - segs.off[s];
  long long lo = t * kTile;
  long long hi = lo + kTile < rows ? lo + kTile : rows;
  for (int d = threadIdx.x; d < ndst; d += blockDim.x)
    run[d] = tile_base[((long long)s * tiles + t) * ndst + d];
  __syncthreads();
  for (int r = 0; r < kRounds; ++r) {
    long long i = lo + (long long)r * otbt::kScanThreads + threadIdx.x;
    bool in = i < hi;
    int d = in ? dest_of(segs.dest[s], segs.valid[s], i, ndst) : ndst;
    unsigned int rank = 0;
    for (int dd = 0; dd < ndst; ++dd) {
      unsigned int bal = __ballot_sync(0xffffffffu, d == dd);
      if (lane == 0) warp_cnt[w][dd] = __popc(bal);
      if (d == dd) rank = __popc(bal & ((1u << lane) - 1u));
    }
    __syncthreads();
    if (in) {
      long long local = region;   // dead rows and overflow: dropped
      if (d < ndst) {
        local = run[d] + rank;
        for (int ww = 0; ww < w; ++ww) local += warp_cnt[ww][d];
      }
      if (local < region) {
        long long p = (long long)d * region + local;
        pos[segs.off[s] + i] = p;
        out_valid[p] = true;
      } else {
        pos[segs.off[s] + i] = -1;
      }
    }
    __syncthreads();
    for (int dd = threadIdx.x; dd < ndst; dd += blockDim.x) {
      unsigned int sum = 0;
      for (int ww = 0; ww < kWarps; ++ww) sum += warp_cnt[ww][dd];
      run[dd] += sum;
    }
    __syncthreads();
  }
}

bool make_segs(const long long* dest_ptrs, const long long* valid_ptrs,
               const long long* rows, int nsrc, Segs* segs) {
  if (nsrc < 1 || nsrc > kMaxDn) return false;
  segs->n = nsrc;
  segs->off[0] = 0;
  for (int s = 0; s < kMaxDn; ++s) {
    bool on = s < nsrc;
    if (on && (rows[s] < 0 || (rows[s] > 0 && valid_ptrs[s] == 0)))
      return false;
    segs->off[s + 1] = segs->off[s] + (on ? rows[s] : 0);
    segs->dest[s] = on ? (const int*)dest_ptrs[s] : nullptr;
    segs->valid[s] = on ? (const bool*)valid_ptrs[s] : nullptr;
  }
  return true;
}

// rows.cuh's scatter of every source's columns to the slots in pos.
int scatter_sources(const Segs& segs, const long long* pos,
                    const long long* in_ptrs, const long long* out_ptrs,
                    const int* widths, int k, cudaStream_t s) {
  for (int src = 0; src < segs.n; ++src) {
    long long n = segs.off[src + 1] - segs.off[src];
    if (n == 0) continue;
    int rc = otbt::for_column_sets(
        in_ptrs + (long long)src * k, out_ptrs, widths, k,
        [&](const otbt::ColSet& c) {
          otbt::scatter_rows<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
              c, pos + segs.off[src], n);
        });
    if (rc != 0) return rc;
  }
  return 0;
}


// ---- the fixed-capacity form: one look-back launch ----

namespace lb = otbt::lb;

constexpr int kXTile = 4096;                     // rows a tile
constexpr int kXThreads = 256;
constexpr int kXWarps = kXThreads / 32;
constexpr int kXWarpRows = kXTile / kXWarps;     // 512 rows a warp
constexpr int kXSteps = kXWarpRows / 32;         // 16 rows a lane
constexpr int kXPadBlocks = 264;
constexpr int kXMaxCols = 64;                    // columns a launch
constexpr int kXMaxPtrs = 248;                   // column pointers a launch

struct XFixed {
  int nsrc, ndst, tiles, k, pad_blocks;
  int mode;                 // 0: ticket, look-back, padding; 1: columns
  long long region;
  int tile_off[kMaxDn + 1];   // source s owns tiles [tile_off[s], [s+1])
  long long rows[kMaxDn];
  const int* dest[kMaxDn];    // or nullptr: every live row to 0
  const bool* valid[kMaxDn];
  unsigned char width[kXMaxCols];
  // output column j at [j], source s's column j at [k + s * k + j]
  const char* ptr[kXMaxPtrs];
  bool* out_valid;
  long long* counts;          // [nsrc, ndst]
  long long* totals;
  long long* over;
  int* ctrl;                  // ndst chains, then nsrc source flags
  unsigned long long* agg;    // [d][tile]
  unsigned long long* grp;    // [d][group]
  unsigned long long* src_incl;   // [s][d]: inclusive at s's last tile
  unsigned long long* tbase;  // [tile][d] for later sets, or nullptr
};
static_assert(sizeof(XFixed) <= 4000, "kernel parameters");

__device__ __forceinline__ lb::Chain<unsigned long long, lb::NoSum> xchain(
    const XFixed& x, int d) {
  const long long groups = (x.tiles + 31) / 32;
  return {x.tiles, x.ctrl + (long long)d * lb::ctrl_words(x.tiles),
          x.agg + (long long)d * x.tiles, nullptr,
          x.grp + (long long)d * groups, nullptr};
}

__device__ __forceinline__ unsigned char code_of(unsigned char v, int d,
                                                 int ndst) {
  return (unsigned char)((v != 0 && d >= 0 && d < ndst) ? d : ndst);
}

// Warp w's 512 rows of the tile as destination codes in code[512 w,
// 512 w + 512): ndst for a dead row or one past the source's end.
// Whole aligned spans: one 16-byte load of valid bytes and four of
// destinations a lane.
__device__ __forceinline__ void stage_codes(const XFixed& x, int s,
                                            long long lo, int nt,
                                            unsigned char* code, int warp,
                                            int lane) {
  const int w0 = warp * kXWarpRows;
  unsigned char* c = code + w0;
  const bool* valid = x.valid[s] + lo + w0;
  const int* dest = x.dest[s] != nullptr ? x.dest[s] + lo + w0 : nullptr;
  const int ndst = x.ndst;
  const bool vec = w0 + kXWarpRows <= nt &&
                   (((unsigned long long)valid) & 15ull) == 0 &&
                   (((unsigned long long)dest) & 15ull) == 0;
  if (vec) {
    const uint4 vb = __ldg(reinterpret_cast<const uint4*>(valid) + lane);
    *reinterpret_cast<uint4*>(c + 16 * lane) = vb;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kXWarpRows / 128; ++j) {
      const int r = 128 * j + 4 * lane;
      int4 dd = make_int4(0, 0, 0, 0);
      if (dest != nullptr) dd = __ldg(reinterpret_cast<const int4*>(dest + r));
      uchar4 v = *reinterpret_cast<const uchar4*>(c + r);
      v.x = code_of(v.x, dd.x, ndst);
      v.y = code_of(v.y, dd.y, ndst);
      v.z = code_of(v.z, dd.z, ndst);
      v.w = code_of(v.w, dd.w, ndst);
      *reinterpret_cast<uchar4*>(c + r) = v;
    }
  } else {
    for (int r = lane; r < kXWarpRows; r += 32) {
      unsigned char cc = (unsigned char)ndst;
      if (w0 + r < nt)
        cc = code_of(valid[r] ? 1 : 0, dest != nullptr ? dest[r] : 0, ndst);
      c[r] = cc;
    }
  }
  __syncwarp();
}

template <class T>
__device__ __forceinline__ void move_col(const char* in_, char* out_,
                                         long long row0,
                                         const long long (&p)[kXSteps]) {
  const T* in = reinterpret_cast<const T*>(in_);
  T* out = reinterpret_cast<T*>(out_);
  T v[kXSteps];
#pragma unroll
  for (int u = 0; u < kXSteps; ++u)
    v[u] = (p[u] >= 0 && in != nullptr) ? __ldg(in + row0 + 32 * u) : T(0);
#pragma unroll
  for (int u = 0; u < kXSteps; ++u)
    if (p[u] >= 0) out[p[u]] = v[u];
}

// a[lo, hi) = false, by thread g of `step`: 16-byte stores in the
// aligned body (a is 16-byte aligned).
__device__ __forceinline__ void fill_false(bool* a, long long lo,
                                           long long hi, long long g,
                                           long long step) {
  const long long alo = (lo + 15) & ~15LL, ahi = hi & ~15LL;
  if (alo >= ahi) {
    for (long long i = lo + g; i < hi; i += step) a[i] = false;
    return;
  }
  for (long long i = lo + g; i < alo; i += step) a[i] = false;
  for (long long i = ahi + g; i < hi; i += step) a[i] = false;
  uint4* v = reinterpret_cast<uint4*>(a + alo);
  const long long nv = (ahi - alo) >> 4;
  for (long long i = g; i < nv; i += step) v[i] = make_uint4(0, 0, 0, 0);
}

// A block after the last tile: wait for every source's last tile, then
// (block 0) the count matrix, totals and overflow, and (every padding
// block) the false tail of each destination's region.
__device__ __forceinline__ void xfixed_pad(const XFixed& x, int b,
                                           unsigned long long* tot) {
  const int* flags = x.ctrl + (long long)x.ndst * lb::ctrl_words(x.tiles);
  const int t = threadIdx.x;
  if (t < x.nsrc && x.tile_off[t + 1] > x.tile_off[t]) {
    while (lb::ld_relaxed(flags + t) == 0) {
    }
  }
  __threadfence();
  __syncthreads();
  for (int d = t; d < x.ndst; d += blockDim.x) {
    unsigned long long e = 0;
    for (int s = 0; s < x.nsrc; ++s) {
      unsigned long long f = e;
      if (x.tile_off[s + 1] > x.tile_off[s])
        f = __ldcg(x.src_incl + (long long)s * x.ndst + d);
      if (b == 0) x.counts[(long long)s * x.ndst + d] = (long long)(f - e);
      e = f;
    }
    tot[d] = e;
    if (b == 0) {
      x.totals[d] = (long long)e;
      x.over[d] = (long long)e > x.region ? (long long)e - x.region : 0;
    }
  }
  __syncthreads();
  const long long g = (long long)b * kXThreads + t;
  const long long step = (long long)x.pad_blocks * kXThreads;
  for (int d = 0; d < x.ndst; ++d) {
    const long long used =
        (long long)tot[d] < x.region ? (long long)tot[d] : x.region;
    fill_false(x.out_valid, d * x.region + used, (d + 1) * x.region, g,
               step);
  }
}

__global__ void __launch_bounds__(kXThreads)
    xchg_fixed_tiles(const __grid_constant__ XFixed x) {
  __shared__ __align__(16) unsigned char code[kXTile];
  __shared__ int wcnt[kXWarps][kMaxDn + 1];
  __shared__ unsigned long long base[kMaxDn];
  __shared__ unsigned long long tagg[kMaxDn];
  __shared__ int sh_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = threadIdx.x;
  const int ndst = x.ndst;
  const int tile = x.mode == 0 ? lb::take_tile(x.ctrl, &sh_tile)
                               : (int)blockIdx.x;
  if (tile >= x.tiles) {
    xfixed_pad(x, tile - x.tiles, base);
    return;
  }
  int s = 0;
  while (x.tile_off[s + 1] <= tile) ++s;
  const long long lo = (long long)(tile - x.tile_off[s]) * kXTile;
  const long long left = x.rows[s] - lo;
  const int nt = left < kXTile ? (int)left : kXTile;
  stage_codes(x, s, lo, nt, code, warp, lane);

  // each row's rank among the warp's rows bound for its destination
  for (int d = lane; d <= ndst; d += 32) wcnt[warp][d] = 0;
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
  const int w0 = warp * kXWarpRows;
  int rk[kXSteps];
#pragma unroll
  for (int u = 0; u < kXSteps; ++u) {
    const int c = code[w0 + 32 * u + lane];
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    const int before = wcnt[warp][c];
    rk[u] = before + __popc(peers & lt);
    __syncwarp();
    if (lane == __ffs(peers) - 1) wcnt[warp][c] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // the warps' exclusive offsets and the tile's count, per destination
  if (t < ndst) {
    int run = 0;
    for (int w = 0; w < kXWarps; ++w) {
      const int e = wcnt[w][t];
      wcnt[w][t] = run;
      run += e;
    }
    tagg[t] = (unsigned long long)run;
    if (x.mode == 0)
      lb::publish(xchain(x, t), tile, (unsigned long long)run, lb::NoSum{});
    else
      base[t] = x.tbase[(long long)tile * ndst + t];
  }
  __syncthreads();
  if (x.mode == 0) {
    for (int d = warp; d < ndst; d += kXWarps) {
      unsigned long long xc;
      lb::NoSum xs;
      lb::look_back(xchain(x, d), tile, lane, tagg[d], lb::NoSum{}, xc, xs);
      if (lane == 0) base[d] = xc;
    }
    __syncthreads();
    if (x.tbase != nullptr && t < ndst)
      x.tbase[(long long)tile * ndst + t] = base[t];
    if (tile == x.tile_off[s + 1] - 1) {
      // the source's last tile: its inclusive prefixes, then its flag
      if (t < ndst) x.src_incl[(long long)s * ndst + t] = base[t] + tagg[t];
      __threadfence();
      __syncthreads();
      if (t == 0)
        lb::st_release(x.ctrl + (long long)ndst * lb::ctrl_words(x.tiles) + s,
                       1);
    }
  }

  // every live row that fits: its slot, its valid byte, its columns
  long long p[kXSteps];
#pragma unroll
  for (int u = 0; u < kXSteps; ++u) {
    const int c = code[w0 + 32 * u + lane];
    p[u] = -1;
    if (c < ndst) {
      const unsigned long long slot =
          base[c] + (unsigned long long)(wcnt[warp][c] + rk[u]);
      if (slot < (unsigned long long)x.region)
        p[u] = (long long)c * x.region + (long long)slot;
    }
  }
  if (x.mode == 0) {
#pragma unroll
    for (int u = 0; u < kXSteps; ++u)
      if (p[u] >= 0) x.out_valid[p[u]] = true;
  }
  const long long row0 = lo + w0 + lane;
  for (int j = 0; j < x.k; ++j) {
    const char* in = x.ptr[x.k + s * x.k + j];
    char* out = const_cast<char*>(x.ptr[j]);
    switch (x.width[j]) {
      case 1:
        move_col<unsigned char>(in, out, row0, p);
        break;
      case 2:
        move_col<unsigned short>(in, out, row0, p);
        break;
      case 4:
        move_col<unsigned int>(in, out, row0, p);
        break;
      default:
        move_col<unsigned long long>(in, out, row0, p);
    }
  }
}

// The fixed form's scratch: the control words (zeroed by the call's
// memset), then the chains' tile and group sums, the sources'
// inclusive prefixes and the tiles' bases.
struct XLayout {
  long long zero_bytes, agg, grp, src_incl, tbase, total;
};

XLayout xfixed_layout(long long tiles, int nsrc, int ndst) {
  const long long cw = lb::ctrl_words(tiles), groups = (tiles + 31) / 32;
  XLayout L;
  L.zero_bytes = 4 * ((long long)ndst * cw + nsrc);
  L.agg = (L.zero_bytes + 15) & ~15LL;
  L.grp = L.agg + 8 * (long long)ndst * tiles;
  L.src_incl = L.grp + 8 * (long long)ndst * groups;
  L.tbase = L.src_incl + 8 * (long long)nsrc * ndst;
  L.total = L.tbase + 8 * tiles * ndst;
  return L;
}

// Tiles of every source (and tile_off, when given); -1 on a bad size.
long long xfixed_tiles(const long long* rows, int nsrc, int* tile_off) {
  long long t = 0;
  for (int s = 0; s < nsrc; ++s) {
    if (tile_off != nullptr) tile_off[s] = (int)t;
    if (rows[s] < 0) return -1;
    t += (rows[s] + kXTile - 1) / kXTile;
    if (t >= (1LL << 30)) return -1;
  }
  if (tile_off != nullptr) tile_off[nsrc] = (int)t;
  return t;
}

}  // namespace

// The exchange's sizes, for the caller's scratch: 1024-row tiles of the
// largest source (>= 1), and the most sources or destinations.
extern "C" long long otbt_exchange_tiles(long long max_rows) {
  long long t = (max_rows + kTile - 1) / kTile;
  return t > 0 ? t : 1;
}

extern "C" long long otbt_exchange_max_dn() { return kMaxDn; }

// Pass 1.  dest_ptrs / valid_ptrs / rows: HOST arrays of nsrc entries,
// source s's int32 destinations (0: every live row to destination 0),
// its bool valid mask and its row count.  tile_counts and tile_base:
// nsrc * tiles * ndst int64 scratch, tiles = otbt_exchange_tiles(the
// largest source's rows); counts: nsrc * ndst int64.
extern "C" int otbt_exchange_count(const long long* dest_ptrs,
                                   const long long* valid_ptrs,
                                   const long long* rows, int nsrc,
                                   int ndst, long long tiles,
                                   void* tile_counts, void* tile_base,
                                   void* counts, void* stream) {
  Segs segs;
  if (!make_segs(dest_ptrs, valid_ptrs, rows, nsrc, &segs) || ndst < 1 ||
      ndst > kMaxDn || tiles < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)tiles, (unsigned)nsrc);
  xchg_tile_counts<<<grid, otbt::kScanThreads, 0, s>>>(
      segs, ndst, tiles, (long long*)tile_counts);
  xchg_tile_scan<<<ndst, otbt::kScanThreads, 0, s>>>(
      (const long long*)tile_counts, nsrc, ndst, tiles,
      (long long*)tile_base, (long long*)counts);
  return (int)cudaGetLastError();
}

// Pass 2, after the host sized `region` from the count matrix: every
// row's slot (pos: one int64 per global row, -1 for a dead row), the
// output valid mask (ndst * region bools, zeroed by the caller), then
// the columns.  in_ptrs: HOST array of nsrc * k entries, source s's k
// columns at [s * k, (s + 1) * k) (0: the source lacks that column, its
// rows get zeros there); out_ptrs / widths: HOST arrays of k.
extern "C" int otbt_exchange_scatter(const long long* dest_ptrs,
                                     const long long* valid_ptrs,
                                     const long long* rows, int nsrc,
                                     int ndst, long long tiles,
                                     const void* tile_base, long long region,
                                     void* pos, void* out_valid,
                                     const long long* in_ptrs,
                                     const long long* out_ptrs,
                                     const int* widths, int k,
                                     void* stream) {
  Segs segs;
  if (!make_segs(dest_ptrs, valid_ptrs, rows, nsrc, &segs) || ndst < 1 ||
      ndst > kMaxDn || tiles < 1 || region < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)tiles, (unsigned)nsrc);
  xchg_positions<<<grid, otbt::kScanThreads, 0, s>>>(
      segs, ndst, tiles, (const long long*)tile_base, region,
      (long long*)pos, (bool*)out_valid);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return scatter_sources(segs, (const long long*)pos, in_ptrs, out_ptrs,
                         widths, k, s);
}


// Scratch bytes of otbt_exchange_fixed over sources of rows[0, nsrc)
// (a HOST array) and ndst destinations; -1 on bad sizes.
extern "C" long long otbt_exchange_fixed_scratch_bytes(const long long* rows,
                                                       int nsrc, int ndst) {
  if (nsrc < 1 || nsrc > kMaxDn || ndst < 1 || ndst > kMaxDn) return -1;
  const long long tiles = xfixed_tiles(rows, nsrc, nullptr);
  if (tiles < 0) return -1;
  return xfixed_layout(tiles, nsrc, ndst).total;
}

// The fixed-capacity form: destination d owns rows [d * region, (d + 1)
// * region) of every output column and of out_valid (ndst * region
// bools, 16-byte aligned, written here in full); rows beyond a region
// are dropped and counted in over[d].  counts: nsrc * ndst int64 (the
// count matrix, left on the device); totals, over: ndst int64 each.
// dest_ptrs / valid_ptrs / rows: HOST arrays of nsrc entries as for
// otbt_exchange_count; in_ptrs / out_ptrs / widths as for
// otbt_exchange_scatter; scratch: otbt_exchange_fixed_scratch_bytes
// bytes, 16-byte aligned.  One memset of the control words and one
// launch (one more launch a column set past the first).
extern "C" int otbt_exchange_fixed(const long long* dest_ptrs,
                                   const long long* valid_ptrs,
                                   const long long* rows, int nsrc,
                                   int ndst, long long region, void* counts,
                                   void* totals, void* over, void* out_valid,
                                   const long long* in_ptrs,
                                   const long long* out_ptrs,
                                   const int* widths, int k, void* scratch,
                                   long long scratch_bytes, void* stream) {
  if (nsrc < 1 || nsrc > kMaxDn || ndst < 1 || ndst > kMaxDn ||
      region < 1 || k < 0 || region > (1LL << 62) / ndst ||
      (((unsigned long long)out_valid) & 15ull) != 0 ||
      (((unsigned long long)scratch) & 15ull) != 0)
    return (int)cudaErrorInvalidValue;
  XFixed x;
  const long long tiles = xfixed_tiles(rows, nsrc, x.tile_off);
  if (tiles < 0 || scratch_bytes < xfixed_layout(tiles, nsrc, ndst).total)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < k; ++j)
    if (widths[j] != 1 && widths[j] != 2 && widths[j] != 4 && widths[j] != 8)
      return (int)cudaErrorInvalidValue;
  const XLayout L = xfixed_layout(tiles, nsrc, ndst);
  unsigned char* sb = (unsigned char*)scratch;
  x.nsrc = nsrc;
  x.ndst = ndst;
  x.tiles = (int)tiles;
  x.region = region;
  for (int s = 0; s < kMaxDn; ++s) {
    const bool on = s < nsrc;
    if (on && rows[s] > 0 && valid_ptrs[s] == 0)
      return (int)cudaErrorInvalidValue;
    x.rows[s] = on ? rows[s] : 0;
    x.dest[s] = on ? (const int*)dest_ptrs[s] : nullptr;
    x.valid[s] = on ? (const bool*)valid_ptrs[s] : nullptr;
  }
  for (int s = nsrc + 1; s <= kMaxDn; ++s) x.tile_off[s] = (int)tiles;
  x.out_valid = (bool*)out_valid;
  x.counts = (long long*)counts;
  x.totals = (long long*)totals;
  x.over = (long long*)over;
  x.ctrl = (int*)sb;
  x.agg = (unsigned long long*)(sb + L.agg);
  x.grp = (unsigned long long*)(sb + L.grp);
  x.src_incl = (unsigned long long*)(sb + L.src_incl);
  // columns a launch: kXMaxCols, fewer where the output's and the
  // sources' pointers would not fit the parameters
  int per = kXMaxPtrs / (nsrc + 1);
  if (per > kXMaxCols) per = kXMaxCols;
  x.tbase = k > per ? (unsigned long long*)(sb + L.tbase) : nullptr;
  long long pad = ((long long)ndst * region + 16LL * 4 * kXThreads - 1) /
                  (16LL * 4 * kXThreads);
  if (pad > kXPadBlocks) pad = kXPadBlocks;
  if (pad < 1) pad = 1;
  x.pad_blocks = (int)pad;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(sb, 0, L.zero_bytes, st);
  if (e != cudaSuccess) return (int)e;
  for (int c0 = 0, set = 0; set == 0 || c0 < k; c0 += per, ++set) {
    const int kc = k - c0 < per ? k - c0 : per;
    x.k = kc;
    x.mode = set == 0 ? 0 : 1;
    for (int j = 0; j < kXMaxCols; ++j)
      x.width[j] = (unsigned char)(j < kc ? widths[c0 + j] : 8);
    for (int i = 0; i < kXMaxPtrs; ++i) x.ptr[i] = nullptr;
    for (int j = 0; j < kc; ++j) {
      x.ptr[j] = (const char*)out_ptrs[c0 + j];
      for (int s = 0; s < nsrc; ++s)
        x.ptr[kc + s * kc + j] =
            (const char*)in_ptrs[(long long)s * k + c0 + j];
    }
    const long long grid = set == 0 ? tiles + pad : tiles;
    if (grid > 0)
      xchg_fixed_tiles<<<(unsigned)grid, kXThreads, 0, st>>>(x);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
