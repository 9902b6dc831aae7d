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
// Four kernels:
// (a) xchg_tile_counts: per (source, 1024-row tile), a shared-memory
//     histogram of destinations;
// (b) xchg_tile_scan: one block per destination scans the tile counts
//     in (source, tile) order (scan.cuh's block scan) into each tile's
//     base offset, and writes the ndn_src x ndn_dst count matrix the
//     host reads once to size the outputs;
// (c) xchg_positions: each tile again, in four rounds of 256 rows; a
//     row's rank among its tile's rows bound for the same destination
//     comes from warp ballots and the per-warp totals, so every live
//     row gets its output slot (and the output valid mask its bit);
// (d) rows.cuh's scatter moves every column and null mask of one
//     source, up to 16 columns of mixed widths a launch.
// Bound: bytes (destinations and the valid mask read twice, each column
// read once and written once for its live rows).
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
      if (d < ndst) {
        long long p = run[d] + rank;
        for (int ww = 0; ww < w; ++ww) p += warp_cnt[ww][d];
        p += (long long)d * region;
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
    if (on && (rows[s] < 0 || valid_ptrs[s] == 0)) return false;
    segs->off[s + 1] = segs->off[s] + (on ? rows[s] : 0);
    segs->dest[s] = on ? (const int*)dest_ptrs[s] : nullptr;
    segs->valid[s] = on ? (const bool*)valid_ptrs[s] : nullptr;
  }
  return true;
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
// rows keep the output's zeros); out_ptrs / widths: HOST arrays of k.
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
  const long long* p = (const long long*)pos;
  for (int src = 0; src < nsrc; ++src) {
    long long n = segs.off[src + 1] - segs.off[src];
    if (n == 0) continue;
    int rc = otbt::for_column_sets(
        in_ptrs + (long long)src * k, out_ptrs, widths, k,
        [&](const otbt::ColSet& c) {
          otbt::scatter_rows<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
              c, p + segs.off[src], n);
        });
    if (rc != 0) return rc;
  }
  return 0;
}
