// Dense grouped aggregation: scatter-reduce into num_groups slots.
//
// Replaces opentenbase_tpu/ops/kernels.py:133 grouped_agg_dense (XLA
// segment_sum / segment_min / segment_max).  Bound: bytes for the
// inputs, but the TPC-H Q1 shape sends 6 M rows into 6 slots, so
// global atomics alone would serialise on a handful of addresses.
// Design: each block accumulates privately in shared memory
// ((n_aggs + 1) x num_groups 8-byte words; the last row is the
// per-group row count, `present`), then merges its partials into the
// global workspace with one atomic per non-identity slot.  When the
// private table does not fit the shared-memory budget the same kernel
// accumulates straight into the global workspace (a design branch, not a
// fallback).
//
// Accumulators: int64 sums are atomicAdd on unsigned long long (two's
// complement, exact in any order); float sums are atomicAdd on double
// (order differs from the reference's, so a tolerance applies);
// min/max are atomicMin/atomicMax on long long for ints and a
// compare-and-swap loop for doubles that propagates NaN as XLA's
// min/max does.  Rows that are not valid, or whose group id is outside
// [0, num_groups), contribute nothing (the reference sends them to an
// overflow slot it drops).
#include "common.cuh"

namespace {

constexpr int kMaxAggs = 32;
enum Kind { kSumInt = 0, kSumFloat = 1, kMin = 2, kMax = 3, kCount = 4 };
enum DType { kI32 = 0, kI64 = 1, kF64 = 2, kBool = 3 };

struct AggArgs {
  int n_aggs;
  int kind[kMaxAggs];
  int dtype[kMaxAggs];
  long long ident[kMaxAggs];   // identity bit pattern of each accumulator
  const void* in[kMaxAggs];
};

__device__ __forceinline__ long long load_int(const void* p, int dt,
                                              long long i) {
  switch (dt) {
    case kI32: return (long long)((const int*)p)[i];
    case kBool: return (long long)((const unsigned char*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

__device__ __forceinline__ double load_float(const void* p, int dt,
                                             long long i) {
  if (dt == kF64) return ((const double*)p)[i];
  return (double)load_int(p, dt, i);
}

__device__ __forceinline__ void atomic_min_f64(unsigned long long* addr,
                                               double v) {
  unsigned long long old = *addr, assumed;
  do {
    assumed = old;
    double cur = __longlong_as_double((long long)assumed);
    if (cur != cur) return;                  // NaN already: stays NaN
    if (!(v != v || v < cur)) return;        // nothing to do
    old = atomicCAS(addr, assumed, (unsigned long long)__double_as_longlong(v));
  } while (old != assumed);
}

__device__ __forceinline__ void atomic_max_f64(unsigned long long* addr,
                                               double v) {
  unsigned long long old = *addr, assumed;
  do {
    assumed = old;
    double cur = __longlong_as_double((long long)assumed);
    if (cur != cur) return;
    if (!(v != v || v > cur)) return;
    old = atomicCAS(addr, assumed, (unsigned long long)__double_as_longlong(v));
  } while (old != assumed);
}

// Fold one value (raw 8-byte word for merges, or a row's input) into an
// accumulator slot.
__device__ __forceinline__ void fold_int(unsigned long long* slot, int kind,
                                         long long v) {
  if (kind == kSumInt || kind == kCount)
    atomicAdd(slot, (unsigned long long)v);
  else if (kind == kMin)
    atomicMin((long long*)slot, v);
  else
    atomicMax((long long*)slot, v);
}

__device__ __forceinline__ void fold_float(unsigned long long* slot, int kind,
                                           double v) {
  if (kind == kSumFloat)
    atomicAdd((double*)slot, v);
  else if (kind == kMin)
    atomic_min_f64(slot, v);
  else
    atomic_max_f64(slot, v);
}

__device__ __forceinline__ bool is_float_acc(int kind, int dt) {
  return kind == kSumFloat || ((kind == kMin || kind == kMax) && dt == kF64);
}

__global__ void grouped_agg_kernel(AggArgs args,
                                   const long long* __restrict__ gid,
                                   const bool* __restrict__ valid,
                                   long long n, int num_groups,
                                   unsigned long long* __restrict__ ws,
                                   bool private_table) {
  extern __shared__ unsigned long long smem[];
  const int rows = args.n_aggs + 1;          // + present
  const int slots = rows * num_groups;
  unsigned long long* acc = private_table ? smem : ws;
  if (private_table) {
    for (int s = threadIdx.x; s < slots; s += blockDim.x) {
      int a = s / num_groups;
      smem[s] = a < args.n_aggs ? (unsigned long long)args.ident[a] : 0ULL;
    }
    __syncthreads();
  }
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!valid[i]) continue;
    long long g = gid[i];
    if (g < 0 || g >= num_groups) continue;
    for (int a = 0; a < args.n_aggs; ++a) {
      unsigned long long* slot = acc + (long long)a * num_groups + g;
      int kind = args.kind[a], dt = args.dtype[a];
      if (kind == kCount)
        atomicAdd(slot, 1ULL);
      else if (is_float_acc(kind, dt))
        fold_float(slot, kind, load_float(args.in[a], dt, i));
      else
        fold_int(slot, kind, load_int(args.in[a], dt, i));
    }
    atomicAdd(acc + (long long)args.n_aggs * num_groups + g, 1ULL);
  }
  if (!private_table) return;
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    int a = s / num_groups;
    unsigned long long v = smem[s];
    if (a == args.n_aggs) {
      if (v) atomicAdd(ws + s, v);
      continue;
    }
    if (v == (unsigned long long)args.ident[a]) continue;
    int kind = args.kind[a], dt = args.dtype[a];
    if (is_float_acc(kind, dt))
      fold_float(ws + s, kind, __longlong_as_double((long long)v));
    else
      fold_int(ws + s, kind, (long long)v);
  }
}

}  // namespace

// ws: (n_aggs + 1) x num_groups 8-byte words on the device, already set
// to each accumulator's identity (0 for sums and the present row).
// in_ptrs / kinds / dtypes / idents are HOST arrays of n_aggs entries.
extern "C" int otbt_grouped_agg_dense(const void* gid, const void* valid,
                                      long long n, int num_groups, int n_aggs,
                                      const long long* in_ptrs,
                                      const int* kinds, const int* dtypes,
                                      const long long* idents, void* ws,
                                      void* stream) {
  if (n_aggs < 0 || n_aggs > kMaxAggs || num_groups <= 0)
    return (int)cudaErrorInvalidValue;
  AggArgs args;
  args.n_aggs = n_aggs;
  for (int a = 0; a < kMaxAggs; ++a) {
    bool live = a < n_aggs;
    args.kind[a] = live ? kinds[a] : 0;
    args.dtype[a] = live ? dtypes[a] : 0;
    args.ident[a] = live ? idents[a] : 0;
    args.in[a] = live ? (const void*)in_ptrs[a] : nullptr;
  }
  if (n <= 0) return (int)cudaGetLastError();
  size_t smem = (size_t)(n_aggs + 1) * (size_t)num_groups * 8;
  // 200 KB of the 227 KB a block may opt into; above it, accumulate in
  // the global workspace directly.
  bool private_table = smem <= 200 * 1024;
  if (private_table && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  grouped_agg_kernel<<<otbt::grid_for(n, 4), otbt::kThreads,
                       private_table ? smem : 0, (cudaStream_t)stream>>>(
      args, (const long long*)gid, (const bool*)valid, n, num_groups,
      (unsigned long long*)ws, private_table);
  return (int)cudaGetLastError();
}
