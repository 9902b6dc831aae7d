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
// rows, 1000 lists and 128 dimensions 256 GFLOP, 3.82 ms at the SIMT
// cores' 67 TFLOP/s, against 516 MB of rows).  No TF32: the reference's
// scores are f32 products, so the products stay exact f32 FMAs on the
// SIMT cores.  What limits such a product is the instructions other
// than FMAs (shared loads, the epilogue) and global loads that do not
// overlap the FMAs; the design:
// - a block of 256 threads takes 128 rows x 128 centroids, each thread
//   8 rows x 8 centroids, reading its operands from k-major shared tiles
//   as four float4 loads for 64 FMAs;
// - a prep launch writes the centroids transposed (d x ldc, ldc =
//   nlist rounded up to 128, zero columns past nlist) with their norms,
//   so a centroid chunk is a 16-byte cp.async.cg copy per four centroids;
// - row chunks are transposed on their way into shared memory by 4-byte
//   cp.async copies (a warp reads 8 dimensions of 4 rows; the tile's
//   stride of 132 floats puts those 32 writes in 32 banks);
// - a ring of 3 stages of 16 dimensions: the copies of the chunk two
//   steps ahead are in flight while a chunk's FMAs run, one block barrier
//   a stage;
// - up to kResidentMaxD dimensions the block keeps its whole row tile in
//   shared memory (at d = 128 66 KB) for the whole centroid loop: each
//   row is read from device memory once, only centroid chunks (L2
//   resident) stream; above it rows stream through the ring too;
// - behind each centroid tile the score (l2 2 v.c - |c|^2, cosine
//   v.c / max(|v| |c|, 1e-30), ip v.c, rounded as the plain version) and
//   the running arg-best per row, so the (n, nlist) score matrix is never
//   written; the 16 threads that share a row (lanes 0-15 or 16-31 of a
//   warp) merge with __shfl_xor_sync.
// The arg-best is jnp.argmax's rule, one comparison (`better`) used by
// the per-thread scan and by the merge: a NaN score ranks above every
// number and the first NaN wins; else the larger score, ties to the
// lower centroid; a row of -inf scores gives 0.  The scan visits
// centroids in increasing index, and its form of the comparison uses
// that: two comparisons a score, where the epilogue is 64 scores a tile.
// Occupancy: __launch_bounds__(256, 2) holds a thread to 128 registers
// (127 on sm_90a, no spills) and the row tile and ring take 92 KB at
// d = 128, so two blocks an SM; otbt_ann_assign_info reports the
// compiled registers, spills and blocks an SM, and chip_smoke.py prints
// them and fails below two blocks.
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

constexpr int kWarps = otbt::kThreads / 32;
constexpr int kBM = 128;          // rows a block tile
constexpr int kBN = 128;          // centroids a block tile
constexpr int kKC = 16;           // dimensions a pipeline stage
constexpr int kStages = 3;        // stages in the ring
constexpr int kAS = kBM + 4;      // k-major row tile stride, in floats
constexpr int kResidentMaxD = 160;   // dims up to which rows stay resident

enum Metric { kL2 = 0, kCosine = 1, kIp = 2 };

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// jnp.argmax's order: does (s, i) beat the current best (b, bi)?  NaN
// above every number, the lower index among NaNs; else the larger score,
// ties to the lower index.  The order is total, so any merge order gives
// the same winner.  kInOrder: the caller visits indices in increasing
// order (a thread's scan), so a tie or a later NaN never wins and the
// test is two comparisons; the scan's sentinel (-inf, INT_MAX) then
// survives a row of -inf scores, which the output maps to 0.
template <bool kInOrder>
__device__ __forceinline__ bool better(float s, int i, float b, int bi) {
  if (kInOrder) return b == b && !(s <= b);
  const bool sn = s != s, bn = b != b;
  if (sn || bn) return sn && (!bn || i < bi);
  return s > b || (s == b && i < bi);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

// One warp a centroid slot c < ldc: its column of centT (d x ldc, zeros
// past nlist) and its norm (|c|^2, or |c| for cosine).
__global__ void cent_prep_kernel(const float* __restrict__ cents, int nlist,
                                 int d, int ldc, int take_sqrt,
                                 float* __restrict__ cnorm,
                                 float* __restrict__ centT) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = blockIdx.x * kWarps + warp; c < ldc;
       c += gridDim.x * kWarps) {
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = c < nlist ? cents[(long long)c * d + j] : 0.f;
      s += v * v;
      centT[(long long)j * ldc + c] = v;
    }
    s = warp_sum(s);
    if (lane == 0 && c < nlist) cnorm[c] = take_sqrt ? sqrtf(s) : s;
  }
}

// Shared memory of one block, in floats: the row tile (resident: every
// dimension, rounded up to kKC; else a ring stage each), the centroid
// ring, and the rows' norms (cosine).
__host__ __device__ constexpr long long assign_smem_floats(bool resident,
                                                           int kdp) {
  return (long long)(resident ? kdp : kStages * kKC) * kAS +
         (long long)kStages * kKC * kBN + kBM;
}

template <int kMetric, bool kResident>
__global__ void __launch_bounds__(otbt::kThreads, 2)
assign_kernel(const float* __restrict__ vecs, long long n, int d,
              const float* __restrict__ centT, int ldc, int nlist,
              const float* __restrict__ cnorm,
              const float* __restrict__ vnorm, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int kdp = (d + kKC - 1) / kKC * kKC;
  float* const as = smem;
  float* const bs = as + (kResident ? kdp : kStages * kKC) * kAS;
  float* const vn_s = bs + kStages * kKC * kBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int nk = kdp / kKC;
  const int steps = nk * ((nlist + kBN - 1) / kBN);

  if (kMetric == kCosine && tid < kBM)
    vn_s[tid] = row0 + tid < n ? vnorm[row0 + tid] : 0.f;

  // step s: dimensions [k0, k0 + kKC) of centroid tile ct into ring
  // stage s % kStages, and of the row tile where it is not resident yet
  auto load = [&](int s) {
    const int ct = s / nk, k0 = (s % nk) * kKC, st = s % kStages;
    float* b = bs + st * kKC * kBN;
    for (int q = tid; q < kKC * kBN / 4; q += otbt::kThreads) {
      const int k = q >> 5, c4 = (q & 31) * 4;
      const bool ok = k0 + k < d;
      cp_async16(b + k * kBN + c4,
                 ok ? centT + (long long)(k0 + k) * ldc + ct * kBN + c4
                    : centT,
                 ok);
    }
    if (kResident && ct > 0) return;
    float* a = kResident ? as + k0 * kAS : as + st * kKC * kAS;
    for (int e = tid; e < kKC * kBM; e += otbt::kThreads) {
      const int k = (e >> 10) * 8 + (e & 7), r = (e >> 3) & (kBM - 1);
      const long long gr = row0 + r;
      const bool ok = gr < n && k0 + k < d;
      cp_async4(a + k * kAS + r, ok ? vecs + gr * d + k0 + k : vecs, ok);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  float acc[8][8];
  float best[8];
  int besti[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = -INFINITY;
    besti[i] = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    cp_async_commit();
    const int st = s % kStages;
    const float* a = kResident ? as + (s % nk) * kKC * kAS
                               : as + st * kKC * kAS;
    const float* b = bs + st * kKC * kBN;
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * kAS + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a + k * kAS + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * kBN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + k * kBN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (s % nk != nk - 1) continue;
    // the tile's scores and the running arg-best, centroids in
    // increasing index
    const int c0 = (s / nk) * kBN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      const float cn = c < nlist ? cnorm[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dot = acc[i][j];
        acc[i][j] = 0.f;
        if (c >= nlist) continue;
        float sc;
        if (kMetric == kIp) {
          sc = dot;
        } else if (kMetric == kCosine) {
          const float vn = vn_s[i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4];
          const float p = __fmul_rn(vn, cn);
          // max(p, 1e-30) that keeps a NaN, as torch.clamp_min
          sc = __fdiv_rn(dot, p < 1e-30f ? 1e-30f : p);
        } else {
          sc = __fsub_rn(__fmul_rn(2.0f, dot), cn);
        }
        if (better<true>(sc, c, best[i], besti[i])) {
          best[i] = sc;
          besti[i] = c;
        }
      }
    }
  }
  cp_async_wait<0>();
  // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, besti[i], o);
      if (better<false>(ob, oi, best[i], besti[i])) {
        best[i] = ob;
        besti[i] = oi;
      }
    }
    const long long gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    // the sentinel left: every score of the row was -inf (argmax's 0)
    if (tx == i && gr < n) out[gr] = besti[i] == 0x7fffffff ? 0 : besti[i];
  }
}

template <int kMetric, bool kResident>
cudaError_t launch_assign(const float* vecs, long long n, int d,
                          const float* centT, int ldc, int nlist,
                          const float* cnorm, const float* vnorm, int* out,
                          cudaStream_t st) {
  const int kdp = (d + kKC - 1) / kKC * kKC;
  const size_t smem = sizeof(float) * (size_t)assign_smem_floats(kResident,
                                                                 kdp);
  // the opt-in above 48 KB, raised once to the largest size a launch has
  // asked for (not a stream operation: a captured launch finds it set)
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        assign_kernel<kMetric, kResident>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  const long long blocks = (n + kBM - 1) / kBM;
  assign_kernel<kMetric, kResident>
      <<<(unsigned)blocks, otbt::kThreads, smem, st>>>(
          vecs, n, d, centT, ldc, nlist, cnorm, vnorm, out);
  return cudaGetLastError();
}

template <int kMetric>
cudaError_t launch_assign_for(bool resident, const float* vecs, long long n,
                              int d, const float* centT, int ldc, int nlist,
                              const float* cnorm, const float* vnorm,
                              int* out, cudaStream_t st) {
  return resident
             ? launch_assign<kMetric, true>(vecs, n, d, centT, ldc, nlist,
                                            cnorm, vnorm, out, st)
             : launch_assign<kMetric, false>(vecs, n, d, centT, ldc, nlist,
                                             cnorm, vnorm, out, st);
}

long long assign_ldc(int nlist) {
  return ((long long)nlist + kBN - 1) / kBN * kBN;
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

// Bytes of otbt_ann_assign's scratch: the transposed centroids (d x ldc
// f32), their norms (ldc f32) and, for cosine, the rows' norms (n f32).
extern "C" long long otbt_ann_assign_scratch_bytes(long long n, int nlist,
                                                   int d, int metric) {
  if (n < 0 || nlist < 1 || d <= 0) return -1;
  const long long ldc = assign_ldc(nlist);
  return 4 * (ldc * d + ldc + (metric == kCosine ? n : 0));
}

// The compiled assignment kernel (l2) for d dimensions: registers a
// thread, local-memory bytes a thread (spills), and resident blocks an
// SM at its shared memory.
extern "C" int otbt_ann_assign_info(int d, int* regs, int* local_bytes,
                                    int* blocks_per_sm) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const int kdp = (d + kKC - 1) / kKC * kKC;
  const bool resident = kdp <= kResidentMaxD;
  const void* fn = resident ? (const void*)assign_kernel<kL2, true>
                            : (const void*)assign_kernel<kL2, false>;
  const size_t smem = sizeof(float) * (size_t)assign_smem_floats(resident,
                                                                 kdp);
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, fn);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      otbt::kThreads, smem);
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return (int)e;
}

// vecs: n x d f32; cents: nlist x d f32; scratch: the bytes above;
// out: n int32 nearest-centroid ids.  Two launches (three for cosine).
extern "C" int otbt_ann_assign(const void* vecs, long long n,
                               const void* cents, int nlist, int d,
                               int metric, void* scratch,
                               long long scratch_bytes, void* out,
                               void* stream) {
  if (n < 0 || nlist < 1 || d <= 0 || metric < 0 || metric > 2 ||
      scratch_bytes < otbt_ann_assign_scratch_bytes(n, nlist, d, metric))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const long long ldc = assign_ldc(nlist);
  float* centT = (float*)scratch;
  float* cnorm = centT + ldc * d;
  float* vnorm = metric == kCosine ? cnorm + ldc : nullptr;
  cent_prep_kernel<<<(int)((ldc + kWarps - 1) / kWarps), otbt::kThreads, 0,
                     st>>>((const float*)cents, nlist, d, (int)ldc,
                           metric == kCosine, cnorm, centT);
  if (metric == kCosine) {
    long long g = (n + kWarps - 1) / kWarps;
    if (g > 132LL * 16) g = 132LL * 16;
    row_norms_kernel<<<(int)g, otbt::kThreads, 0, st>>>(
        (const float*)vecs, n, d, 1, vnorm);
  }
  const bool resident = (d + kKC - 1) / kKC * kKC <= kResidentMaxD;
  const float* v = (const float*)vecs;
  const int c = (int)ldc;
  int* o = (int*)out;
  cudaError_t e;
  if (metric == kL2)
    e = launch_assign_for<kL2>(resident, v, n, d, centT, c, nlist, cnorm,
                               vnorm, o, st);
  else if (metric == kCosine)
    e = launch_assign_for<kCosine>(resident, v, n, d, centT, c, nlist, cnorm,
                                   vnorm, o, st);
  else
    e = launch_assign_for<kIp>(resident, v, n, d, centT, c, nlist, cnorm,
                               vnorm, o, st);
  return (int)e;
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
