// K3: stream compaction of the live rows of k columns to a prefix.
//
// Replaces opentenbase_tpu/ops/kernels.py:103 compact (jnp.nonzero with
// size=out_size, fill 0, then a gather per column) and its use in
// exec/mesh_exec.py:853 _compact_local, the compaction of every
// DataNode's gather output before it crosses to the coordinator.  Same
// result: the first min(count, out_size) live rows in row order, then
// padding rows that repeat row 0, and count = the number of live rows.
//
// Bound: bytes (the mask read, each column read once and its out_size
// rows written once), a few kilobytes on the cluster program's calls,
// so launches and the host set the time.  Design: one launch.  A warp
// takes 16 words of 32 rows: a __ballot_sync of the mask a word, its
// __popc, the warps' counts scanned in shared memory; each live row's
// slot is its warp's offset plus the popcounts before it, and the lanes
// of a word write neighbouring slots.  Every column of the launch (up
// to 128, of widths 1, 2, 4 and 8 bytes) is moved in it, one branch on
// the width a column (a branch an entry kept the loads from being in
// flight together), row 0 for the padding read once.  A call of more
// columns is one launch a set of 128 (ops/kernels.py compact).
// - Up to `one_rows` rows and output slots (the caller's limit,
//   ops/kernels.py COMPACT_ONE_ROWS): one block of 1024 threads takes
//   16384 rows a pass, carrying the live count from pass to pass, then
//   writes the padding and the count: one launch, no scratch.
// - Above: tiles of 4096 rows chained by lookback.cuh's single-pass
//   look-back (the scan K13b's wfr_scan uses, here over int32 counts),
//   each tile writing its own live rows; the last tile writes the count
//   and publishes it to padding blocks that take tickets after every
//   tile and write the padding rows: one memset of the control words
//   and one launch, both on the stream (a CUDA graph captures them).
#include "common.cuh"
#include "lookback.cuh"

namespace {

namespace lb = otbt::lb;

constexpr int kMaxCols = 128;
constexpr int kWords = 16;                                   // a warp's
constexpr int kWarpRows = 32 * kWords;                       // 512 rows
constexpr int kTileThreads = 256;
constexpr int kTileRows = (kTileThreads / 32) * kWarpRows;   // 4096
constexpr int kOneThreads = 1024;
constexpr int kPassRows = (kOneThreads / 32) * kWarpRows;    // 16384
constexpr int kMaxPadBlocks = 264;

struct Cols {
  int k;
  unsigned char width[kMaxCols];
  const void* in[kMaxCols];
  void* out[kMaxCols];
};

// Entry i of column j, zero-extended to 64 bits, and its store.
__device__ __forceinline__ unsigned long long load_entry(const Cols& c, int j,
                                                         long long i) {
  switch (c.width[j]) {
    case 1: return ((const uint8_t*)c.in[j])[i];
    case 2: return ((const uint16_t*)c.in[j])[i];
    case 4: return ((const uint32_t*)c.in[j])[i];
    default: return ((const unsigned long long*)c.in[j])[i];
  }
}
__device__ __forceinline__ void store_entry(const Cols& c, int j, long long i,
                                            unsigned long long v) {
  switch (c.width[j]) {
    case 1: ((uint8_t*)c.out[j])[i] = (uint8_t)v; break;
    case 2: ((uint16_t*)c.out[j])[i] = (uint16_t)v; break;
    case 4: ((uint32_t*)c.out[j])[i] = (uint32_t)v; break;
    default: ((unsigned long long*)c.out[j])[i] = v;
  }
}

// Row 0 of every column into sh (threads below c.k; sh: kMaxCols).
__device__ __forceinline__ void load_row0(const Cols& c,
                                          unsigned long long* sh) {
  if ((int)threadIdx.x < c.k) sh[threadIdx.x] = load_entry(c, threadIdx.x, 0);
}

// Slots first, first + step, ... below out_size of every column get row
// 0 (row0: load_row0's values, after a barrier): stores only.
__device__ __forceinline__ void fill_row0(const Cols& c,
                                          const unsigned long long* row0,
                                          long long first, long long step,
                                          long long out_size) {
  for (int j = 0; j < c.k; ++j) {
    const unsigned long long v = row0[j];
    for (long long i = first; i < out_size; i += step) store_entry(c, j, i, v);
  }
}

// Warp `warp`'s 16 ballots over rows base + 512 warp + 32 k + lane; its
// live count (the same in every lane).
__device__ __forceinline__ int tile_ballots(const unsigned char* m,
                                            long long n, long long base,
                                            unsigned (&ball)[kWords],
                                            int lane, int warp) {
  const long long r = base + (long long)warp * kWarpRows + lane;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const long long i = r + 32 * k;
    ball[k] = __ballot_sync(lb::kFull, i < n && m[i] != 0);
    cnt += __popc(ball[k]);
  }
  return cnt;
}

// sh[32 + w]: warp w's exclusive offset in the tile; returns the tile's
// count.  sh: 65 ints.
template <int kT>
__device__ __forceinline__ int tile_offsets(int cnt, int* sh, int lane,
                                            int warp) {
  constexpr int kW = kT / 32;
  if (lane == 0) sh[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kW ? sh[lane] : 0;
    const int inc = lb::warp_incl(v, lane);
    if (lane < kW) sh[32 + lane] = inc - v;
    if (lane == 31) sh[64] = inc;
  }
  __syncthreads();
  return sh[64];
}

// One column's entries of the thread's 16 rows r + 32 k to their slots
// (-1: none): the 16 loads in flight before the stores.
template <class T>
__device__ __forceinline__ void move_words(const void* in, void* out,
                                           long long r,
                                           const int (&slot)[kWords]) {
  const T* src = (const T*)in;
  T* dst = (T*)out;
  T v[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    v[k] = slot[k] >= 0 ? src[r + 32 * k] : T(0);
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    if (slot[k] >= 0) dst[slot[k]] = v[k];
}

// The warp's live rows to slots off, off + 1, ... (those below out_size).
// Column by column, one branch on the width a column.
__device__ __forceinline__ void tile_write(const Cols& c, long long base,
                                           const unsigned (&ball)[kWords],
                                           long long off, long long out_size,
                                           int lane, int warp) {
  const long long r = base + (long long)warp * kWarpRows + lane;
  const unsigned lt = (1u << lane) - 1u;
  int slot[kWords];   // below n < 2^31; -1: no row to move
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const unsigned b = ball[k];
    const long long s = off + __popc(b & lt);
    slot[k] = ((b >> lane) & 1u) && s < out_size ? (int)s : -1;
    off += __popc(b);
  }
  for (int j = 0; j < c.k; ++j) {
    switch (c.width[j]) {
      case 1: move_words<uint8_t>(c.in[j], c.out[j], r, slot); break;
      case 2: move_words<uint16_t>(c.in[j], c.out[j], r, slot); break;
      case 4: move_words<uint32_t>(c.in[j], c.out[j], r, slot); break;
      default: move_words<unsigned long long>(c.in[j], c.out[j], r, slot);
    }
  }
}

__global__ void __launch_bounds__(kOneThreads)
    compact_one(const unsigned char* __restrict__ mask, long long n,
                long long out_size, long long* __restrict__ count, Cols c) {
  __shared__ int sh[65];
  __shared__ unsigned long long row0[kMaxCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_row0(c, row0);
  long long total = 0;
  for (long long base = 0; base < n; base += kPassRows) {
    unsigned ball[kWords];
    const int cnt = tile_ballots(mask, n, base, ball, lane, warp);
    const int pc = tile_offsets<kOneThreads>(cnt, sh, lane, warp);
    tile_write(c, base, ball, total + sh[32 + warp], out_size, lane, warp);
    total += pc;
    __syncthreads();   // sh is the next pass's
  }
  const long long lo = total < out_size ? total : out_size;
  fill_row0(c, row0, lo + threadIdx.x, kOneThreads, out_size);
  if (threadIdx.x == 0) *count = total;
}

// ctrl: the chain's control words (lb::ctrl_words(tiles)), then [0] the
// total is published and [1] the total; agg: tiles ints; grp: one int a
// group of 32 tiles.  Blocks past the tiles write the padding.
__global__ void __launch_bounds__(kTileThreads)
    compact_tiles(const unsigned char* __restrict__ mask, long long n,
                  long long out_size, long long* __restrict__ count, Cols c,
                  int tiles, int pad_blocks, int* ctrl, int* agg, int* grp) {
  __shared__ int sh[65];
  __shared__ int sh_tile, sh_x;
  __shared__ unsigned long long row0[kMaxCols];
  const lb::Chain<int, lb::NoSum> ch{tiles, ctrl, agg, nullptr, grp,
                                     nullptr};
  const int tile = lb::take_tile(ctrl, &sh_tile);
  int* done = ctrl + lb::ctrl_words(tiles);
  if (tile >= tiles) {
    // a padding block: every tile took its ticket before this one, so
    // every tile is running and the last one publishes the total
    load_row0(c, row0);
    if (threadIdx.x == 0) {
      while (lb::ld_relaxed(done) == 0) {
      }
      __threadfence();
      sh_x = __ldcg(done + 1);
    }
    __syncthreads();
    const long long total = sh_x;
    const long long lo = total < out_size ? total : out_size;
    fill_row0(c, row0,
              lo + (long long)(tile - tiles) * kTileThreads + threadIdx.x,
              (long long)pad_blocks * kTileThreads, out_size);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)tile * kTileRows;
  unsigned ball[kWords];
  const int cnt = tile_ballots(mask, n, base, ball, lane, warp);
  const int bc = tile_offsets<kTileThreads>(cnt, sh, lane, warp);
  if (threadIdx.x == 0) lb::publish(ch, tile, bc, lb::NoSum{});
  if (warp == 0) {
    int xc;
    lb::NoSum xs;
    lb::look_back(ch, tile, lane, bc, lb::NoSum{}, xc, xs);
    if (lane == 0) sh_x = xc;
  }
  __syncthreads();
  const long long x = sh_x;
  tile_write(c, base, ball, x + sh[32 + warp], out_size, lane, warp);
  if (tile == tiles - 1 && threadIdx.x == 0) {
    const int total = (int)x + bc;
    *count = total;
    done[1] = total;
    lb::st_release(done, 1);
  }
}

long long tiles_of(long long n) { return (n + kTileRows - 1) / kTileRows; }

bool one_block(long long n, long long out_size, long long one_rows) {
  return n <= one_rows && out_size <= one_rows;
}

// Scratch bytes of a compaction of n rows into out_size slots: 0 on the
// one-block path, else the multi-tile form's int32 words.
long long scratch_bytes_of(long long n, long long out_size,
                           long long one_rows) {
  if (one_block(n, out_size, one_rows)) return 0;
  const long long tiles = tiles_of(n);
  return 4 * (lb::ctrl_words(tiles) + 2 + tiles + (tiles + 31) / 32);
}

}  // namespace

// The scratch otbt_compact needs (bytes; 0: none).
extern "C" long long otbt_compact_scratch_bytes(long long n,
                                                long long out_size,
                                                long long one_rows) {
  return scratch_bytes_of(n, out_size, one_rows);
}

// mask: n bools; count: one int64 (written); one_rows: the one-block
// path's limit; scratch: otbt_compact_scratch_bytes(n, out_size,
// one_rows) bytes.  in_ptrs / out_ptrs / widths: HOST arrays of k <= 128
// entries (out columns hold out_size rows).
extern "C" int otbt_compact(const void* mask, long long n, long long out_size,
                            long long one_rows, void* scratch,
                            long long scratch_bytes, void* count,
                            const long long* in_ptrs,
                            const long long* out_ptrs, const int* widths,
                            int k, void* stream) {
  if (n < 1 || out_size < 1 || n >= (1LL << 31) - 1 || k < 0 ||
      k > kMaxCols)
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes < scratch_bytes_of(n, out_size, one_rows))
    return (int)cudaErrorInvalidValue;
  Cols c;
  c.k = k;
  for (int j = 0; j < kMaxCols; ++j) {
    const bool on = j < k;
    const int w = on ? widths[j] : 8;
    if (w != 1 && w != 2 && w != 4 && w != 8)
      return (int)cudaErrorInvalidValue;
    c.width[j] = (unsigned char)w;
    c.in[j] = on ? (const void*)in_ptrs[j] : nullptr;
    c.out[j] = on ? (void*)out_ptrs[j] : nullptr;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* m = (const unsigned char*)mask;
  if (one_block(n, out_size, one_rows)) {
    compact_one<<<1, kOneThreads, 0, s>>>(m, n, out_size, (long long*)count,
                                         c);
    return (int)cudaGetLastError();
  }
  const long long tiles = tiles_of(n);
  const long long words = lb::ctrl_words(tiles) + 2;
  int* ctrl = (int*)scratch;
  cudaError_t e = cudaMemsetAsync(ctrl, 0, 4 * words, s);
  if (e != cudaSuccess) return (int)e;
  long long pad = (out_size + 1023) / 1024;
  if (pad > kMaxPadBlocks) pad = kMaxPadBlocks;
  compact_tiles<<<(unsigned)(tiles + pad), kTileThreads, 0, s>>>(
      m, n, out_size, (long long*)count, c, (int)tiles, (int)pad, ctrl,
      ctrl + words, ctrl + words + tiles);
  return (int)cudaGetLastError();
}
