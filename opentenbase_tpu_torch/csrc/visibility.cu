// GTS MVCC visibility mask, one thread per row.
//
// Replaces opentenbase_tpu/ops/kernels.py:40 visibility_mask (a jnp
// expression that XLA fused into the scan).  Bound: bytes.  It reads
// four int64 system columns and writes one byte per row, 33 bytes a
// row; the design is a plain grid-stride elementwise pass with
// coalesced 8-byte loads, so it runs at the card's memory rate.
//
// Two entries: the snapshot and txid by value (the eager tier), or read
// from device memory (otbt_visibility_mask_dev: a captured fragment
// program, exec/fused.py, rewrites them before every replay, so they
// must not be baked into the graph's kernel arguments).
#include "common.cuh"

namespace {

__global__ void visibility_kernel(const long long* __restrict__ xmin_ts,
                                  const long long* __restrict__ xmax_ts,
                                  const long long* __restrict__ xmin_txid,
                                  const long long* __restrict__ xmax_txid,
                                  long long snap_ts, long long my_txid,
                                  const long long* __restrict__ snap_dev,
                                  const long long* __restrict__ txid_dev,
                                  long long aborted_ts,
                                  bool* __restrict__ out, long long n) {
  if (snap_dev != nullptr) {
    snap_ts = *snap_dev;
    my_txid = *txid_dev;
  }
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    long long xmin = xmin_ts[i];
    bool ins = (xmin <= snap_ts) ||
               ((xmin_txid[i] == my_txid) && (xmin != aborted_ts));
    bool dele = (xmax_ts[i] <= snap_ts) || (xmax_txid[i] == my_txid);
    out[i] = ins && !dele;
  }
}

}  // namespace

extern "C" int otbt_visibility_mask(const void* xmin_ts, const void* xmax_ts,
                                    const void* xmin_txid,
                                    const void* xmax_txid, long long snap_ts,
                                    long long my_txid, long long aborted_ts,
                                    void* out, long long n, void* stream) {
  if (n > 0) {
    visibility_kernel<<<otbt::grid_for(n), otbt::kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const long long*)xmin_ts, (const long long*)xmax_ts,
        (const long long*)xmin_txid, (const long long*)xmax_txid, snap_ts,
        my_txid, nullptr, nullptr, aborted_ts, (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

// snap_ts / my_txid: one int64 each in device memory.
extern "C" int otbt_visibility_mask_dev(const void* xmin_ts,
                                        const void* xmax_ts,
                                        const void* xmin_txid,
                                        const void* xmax_txid,
                                        const void* snap_ts,
                                        const void* my_txid,
                                        long long aborted_ts, void* out,
                                        long long n, void* stream) {
  if (snap_ts == nullptr || my_txid == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    visibility_kernel<<<otbt::grid_for(n), otbt::kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const long long*)xmin_ts, (const long long*)xmax_ts,
        (const long long*)xmin_txid, (const long long*)xmax_txid, 0, 0,
        (const long long*)snap_ts, (const long long*)my_txid, aborted_ts,
        (bool*)out, n);
  }
  return (int)cudaGetLastError();
}
