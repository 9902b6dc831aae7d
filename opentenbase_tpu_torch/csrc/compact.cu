// K3: stream compaction of the live rows of k columns to a prefix.
//
// Replaces opentenbase_tpu/ops/kernels.py:103 compact (jnp.nonzero with
// size=out_size, fill 0, then a gather per column) and its use in
// exec/mesh_exec.py:853 _compact_local, the compaction of every
// DataNode's gather output before it crosses to the coordinator.  Same
// result: the first min(count, out_size) live rows in row order, then
// padding rows that repeat row 0, and count = the number of live rows.
//
// Design: an exclusive scan of the mask (scan.cuh: tile sums, a
// one-block scan of the tile sums, the tile scan with its offset added
// back) gives every live row its output slot; one pass scatters the
// live rows of every column to their slots (rows.cuh, up to 16 columns
// of mixed widths a launch, coalesced reads), and a last pass writes
// row 0 into the padding slots, reading the count on the device.  The
// count stays on the device.  Bound: bytes (the mask read, each column
// read once and its out_size rows written once).
#include "rows.cuh"
#include "scan.cuh"

namespace {

struct MaskLoad {
  const bool* m;
  __device__ long long operator()(long long i) const { return m[i] ? 1 : 0; }
};

__global__ void compact_slots(const bool* __restrict__ mask,
                              const long long* __restrict__ excl, long long n,
                              long long out_size, long long* __restrict__ pos) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    pos[i] = (mask[i] && excl[i] < out_size) ? excl[i] : -1;
}

}  // namespace

// mask: n bools.  excl, pos: n int64 scratch; tiles: otbt_scan_tiles(n)
// int64 scratch; count: one int64 (written).  in_ptrs / out_ptrs /
// widths: HOST arrays of k entries (out columns hold out_size rows).
extern "C" int otbt_compact(const void* mask, long long n, long long out_size,
                            void* excl, void* tiles, void* count, void* pos,
                            const long long* in_ptrs, const long long* out_ptrs,
                            const int* widths, int k, void* stream) {
  if (n < 1 || out_size < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool* m = (const bool*)mask;
  otbt::exclusive_scan(MaskLoad{m}, n, (long long*)excl, (long long*)tiles,
                       (long long*)count, s);
  compact_slots<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(
      m, (const long long*)excl, n, out_size, (long long*)pos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long* p = (const long long*)pos;
  const long long* cnt = (const long long*)count;
  return otbt::for_column_sets(
      in_ptrs, out_ptrs, widths, k, [&](const otbt::ColSet& c) {
        otbt::scatter_rows<<<otbt::grid_for(n), otbt::kThreads, 0, s>>>(c, p,
                                                                       n);
        otbt::fill_tail_row0<<<otbt::grid_for(out_size), otbt::kThreads, 0,
                               s>>>(c, cnt, out_size);
      });
}
