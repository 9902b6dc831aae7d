// IVF coarse quantizer (K15c): nearest-centroid assignment and the Lloyd
// centroid update.
//
// Replaces opentenbase_tpu/ops/ann.py:47 assign_clusters (an (n, d) x
// (d, nlist) matmul on the MXU, then a per-row argmax of the metric's
// score) and :65 _lloyd_step (segment sums of the rows and of ones per
// cluster, then sum / max(count, 1), an empty cluster keeping its
// previous centroid).
//
// Assignment.  Bound: operations (2 n nlist d multiply-adds; at 1 M
// rows, 1000 lists and 128 dimensions 256 GFLOP against 516 MB of rows).
// A tiled f32 product on the SIMT cores: a block of 256 threads holds a
// 64-row tile of vectors and a 64-centroid tile in shared memory, 32
// dimensions at a time, each thread forming a 4 x 4 block of dot
// products; the score epilogue (l2 2 v.c - |c|^2, cosine
// v.c / max(|v| |c|, 1e-30), ip v.c) and the running arg-best per row are
// fused behind each centroid tile, so the (n, nlist) score matrix is
// never written.  Ties go to the lower centroid index, as jnp.argmax.
// No TF32: the reference's scores are f32 products.
//
// Update.  Reproducible: the same rows give the same centroids bit for
// bit, so no float atomics.  The wrapper orders the rows by (cluster,
// row) with the sort kernel (csrc/sort.cu); here one pass finds each
// cluster's run in that order, and one block per cluster sums its run in
// a fixed order (warp w takes the run's rows w, w + 8, ...; the eight
// partial sums are added in warp order).  Bound: bytes (each valid row
// read once).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kTM = 64;    // rows per block tile
constexpr int kTC = 64;    // centroids per block tile
constexpr int kTK = 32;    // dimensions per shared-memory stage
constexpr int kWarps = otbt::kThreads / 32;

enum Metric { kL2 = 0, kCosine = 1, kIp = 2 };

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// out[r] = sum_j x[r, j]^2 (sqrt'ed when take_sqrt), one warp per row
__global__ void row_norms_kernel(const float* __restrict__ x, long long n,
                                 int d, int take_sqrt,
                                 float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n;
       r += stride) {
    const float* v = x + r * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s += v[j] * v[j];
    s = warp_sum(s);
    if (lane == 0) out[r] = take_sqrt ? sqrtf(s) : s;
  }
}

__global__ void __launch_bounds__(otbt::kThreads)
assign_kernel(const float* __restrict__ vecs, long long n,
              const float* __restrict__ cents, int nlist, int d,
              const float* __restrict__ cnorm, const float* __restrict__ vnorm,
              int metric, int* __restrict__ out) {
  __shared__ float as[kTK][kTM + 1];
  __shared__ float bs[kTK][kTC + 1];
  __shared__ float red_s[16][kTM];
  __shared__ int red_i[16][kTM];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row0 = (long long)blockIdx.x * kTM;

  float best[4];
  int besti[4];
  float vn[4];
  for (int i = 0; i < 4; ++i) {
    best[i] = -INFINITY;
    besti[i] = 0x7fffffff;
    long long r = row0 + ty * 4 + i;
    vn[i] = (metric == kCosine && r < n) ? vnorm[r] : 0.f;
  }

  for (int c0 = 0; c0 < nlist; c0 += kTC) {
    float acc[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kTK) {
      // coalesced: consecutive threads read consecutive dimensions of a row
      for (int e = threadIdx.x; e < kTM * kTK; e += otbt::kThreads) {
        int r = e / kTK, kk = e % kTK;
        long long gr = row0 + r;
        int gk = k0 + kk;
        as[kk][r] = (gr < n && gk < d) ? vecs[gr * d + gk] : 0.f;
        int gc = c0 + r;
        bs[kk][r] = (gc < nlist && gk < d) ? cents[(long long)gc * d + gk]
                                           : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTK; ++kk) {
        float a[4], b[4];
        for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
        for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx * 4 + j];
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    for (int j = 0; j < 4; ++j) {
      int c = c0 + tx * 4 + j;
      if (c >= nlist) continue;
      float cn = cnorm != nullptr ? cnorm[c] : 0.f;
      for (int i = 0; i < 4; ++i) {
        float dot = acc[i][j], s;
        if (metric == kIp) {
          s = dot;
        } else if (metric == kCosine) {
          s = __fdiv_rn(dot, fmaxf(__fmul_rn(vn[i], cn), 1e-30f));
        } else {
          s = __fsub_rn(__fmul_rn(2.0f, dot), cn);
        }
        // columns visit in increasing index: strict > keeps the first max
        if (s > best[i] || (s == best[i] && c < besti[i])) {
          best[i] = s;
          besti[i] = c;
        }
      }
    }
  }
  for (int i = 0; i < 4; ++i) {
    red_s[tx][ty * 4 + i] = best[i];
    red_i[tx][ty * 4 + i] = besti[i];
  }
  __syncthreads();
  if (threadIdx.x < kTM) {
    int r = threadIdx.x;
    float b = red_s[0][r];
    int bi = red_i[0][r];
    for (int t = 1; t < 16; ++t) {
      float s = red_s[t][r];
      int si = red_i[t][r];
      if (s > b || (s == b && si < bi)) {
        b = s;
        bi = si;
      }
    }
    long long gr = row0 + r;
    // no score above -inf (every one -inf): argmax's first index
    if (gr < n) out[gr] = bi == 0x7fffffff ? 0 : bi;
  }
}

// start/end of each cluster's run in the sorted order (zero when empty);
// keys[row] is the row's cluster, nlist for an invalid row (sorted last)
__global__ void cluster_bounds_kernel(const long long* __restrict__ keys,
                                      const long long* __restrict__ perm,
                                      long long n, int nlist,
                                      long long* __restrict__ start,
                                      long long* __restrict__ end) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    long long c = keys[perm[p]];
    if (c < 0 || c >= nlist) continue;
    long long prev = p > 0 ? keys[perm[p - 1]] : -1;
    long long next = p + 1 < n ? keys[perm[p + 1]] : nlist;
    if (c != prev) start[c] = p;
    if (c != next) end[c] = p + 1;
  }
}

// one block per cluster: sum its run in a fixed order, divide, or keep the
// previous centroid when the run is empty
__global__ void lloyd_update_kernel(const float* __restrict__ vecs, int d,
                                    const long long* __restrict__ perm,
                                    const long long* __restrict__ start,
                                    const long long* __restrict__ end,
                                    const float* __restrict__ old,
                                    float* __restrict__ out) {
  extern __shared__ float part[];   // kWarps x d partial sums
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long lo = start[c], hi = end[c];
  for (int jc = 0; jc < d; jc += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (long long p = lo + warp; p < hi; p += kWarps) {
      const float* v = vecs + perm[p] * d;
      for (int t = 0; t < 4; ++t) {
        int j = jc + lane + 32 * t;
        if (j < d) acc[t] = __fadd_rn(acc[t], v[j]);
      }
    }
    for (int t = 0; t < 4; ++t) {
      int j = jc + lane + 32 * t;
      if (j < d) part[warp * d + j] = acc[t];
    }
  }
  __syncthreads();
  const long long cnt = hi - lo;
  const float fcnt = (float)cnt;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float s = part[j];
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, part[w * d + j]);
    out[(long long)c * d + j] =
        cnt > 0 ? __fdiv_rn(s, fmaxf(fcnt, 1.0f)) : old[(long long)c * d + j];
  }
}

}  // namespace

// vecs: n x d f32; cents: nlist x d f32; scratch: nlist f32 (+ n f32 for
// cosine); out: n int32 nearest-centroid ids.
extern "C" int otbt_ann_assign(const void* vecs, long long n, const void* cents,
                               int nlist, int d, int metric, void* scratch,
                               void* out, void* stream) {
  if (n < 0 || nlist < 1 || d <= 0 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  float* cnorm = (float*)scratch;
  float* vnorm = nullptr;
  if (metric != kIp) {
    int g = (int)((nlist + kWarps - 1) / kWarps);
    row_norms_kernel<<<g, otbt::kThreads, 0, st>>>(
        (const float*)cents, nlist, d, metric == kCosine, cnorm);
  }
  if (metric == kCosine) {
    vnorm = cnorm + nlist;
    long long g = (n + kWarps - 1) / kWarps;
    if (g > 132LL * 16) g = 132LL * 16;
    row_norms_kernel<<<(int)g, otbt::kThreads, 0, st>>>(
        (const float*)vecs, n, d, 1, vnorm);
  }
  long long blocks = (n + kTM - 1) / kTM;
  assign_kernel<<<(unsigned)blocks, otbt::kThreads, 0, st>>>(
      (const float*)vecs, n, (const float*)cents, nlist, d,
      metric == kIp ? nullptr : cnorm, vnorm, metric, (int*)out);
  return (int)cudaGetLastError();
}

// keys: n int64 (cluster, or nlist for an invalid row); perm: n int64, the
// rows in (key, row) order; old/out: nlist x d f32; bounds: 2 nlist int64
// scratch.
extern "C" int otbt_ann_lloyd_update(const void* vecs, long long n, int d,
                                     const void* keys, const void* perm,
                                     int nlist, const void* old, void* out,
                                     void* bounds, void* stream) {
  if (n < 0 || d <= 0 || nlist < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long* start = (long long*)bounds;
  long long* end = start + nlist;
  cudaMemsetAsync(bounds, 0, sizeof(long long) * 2 * (size_t)nlist, st);
  if (n > 0)
    cluster_bounds_kernel<<<otbt::grid_for(n), otbt::kThreads, 0, st>>>(
        (const long long*)keys, (const long long*)perm, n, nlist, start, end);
  size_t smem = (size_t)kWarps * d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lloyd_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lloyd_update_kernel<<<nlist, otbt::kThreads, smem, st>>>(
      (const float*)vecs, d, (const long long*)perm, start, end,
      (const float*)old, (float*)out);
  return (int)cudaGetLastError();
}
