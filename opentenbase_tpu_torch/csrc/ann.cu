// Vector search (K15): distances, top-k nearest, and the IVF probe scan.
//
// Replaces opentenbase_tpu/ops/ann.py:21 distances (one (n, d) x (d,)
// GEMV on the MXU plus a norm epilogue), :39 topk_nearest (lax.top_k of
// the masked distances) and :98 ivf_search (probe the nprobe nearest
// lists, rank every row with unprobed rows masked to +inf, top-k).
//
// Distances.  Bound: bytes.  Every row is read once (4 d bytes) and one
// f32 written, with 2 d multiply-adds per row: far below the card's
// operations-per-byte line.  One warp per row reads the row with float4
// loads (a 128-d row is one 16-byte load per lane), forming v.q and
// |v|^2 in the same pass, so the norm costs no second read; q and |q|^2
// are staged once per block in shared memory.  The epilogue is the
// reference's, term for term and without contraction into fused
// multiply-adds: l2 sqrt(max(|v|^2 - 2 v.q + |q|^2, 0)), cosine
// 1 - v.q / max(|v| |q|, 1e-30), ip -v.q, where max keeps a NaN as
// jnp.maximum and torch.clamp_min do: a row with an infinite component
// gives l2's inf - inf, NaN, never a clamped 0.
//
// Top-k.  The k smallest (distance, row) pairs in one total order:
// ascending distance, -0.0 as 0.0, every NaN (either sign, any payload)
// one step above +inf, masked rows as +inf, ties to the lower row (the
// plain version's stable sort, PostgreSQL's float order).  Each pair
// packs into one u64 word (the f32's order-preserving bits above the
// row), so the order is a plain integer order and no two rows tie.
// One launch.  Each warp streams 128-row chunks (a float4 of distances
// and four valid bytes a lane) and keeps its S = pow2(k) smallest words
// sorted in shared memory, with the k-th of them as a threshold: a row
// whose word is not below it is dropped after one comparison, the rest
// go to the warp's queue, which is sorted and merged into the list when
// it fills (a bitonic sort in registers across the warp's lanes, then
// the S smallest of the two sorted runs by one min pass and a bitonic
// merge, in registers up to S = 256).  The block merges its warps'
// lists in a tree and publishes its S words; the last block to finish
// (a ticket) streams every block's words through the same select and
// writes rows and distances.  Bound: bytes (n distances and masks read
// once); after the first chunks almost every row costs one comparison,
// and the sorts and merges, not the reads, set the time.
//
// Probe scan.  The reference computes every row's distance and masks
// rows of unprobed lists afterwards, to keep shapes static.  Here one
// warp per row reads assign[row] and the probed bitmap first and reads
// the vector only for a valid row of a probed list, writing +inf for the
// others: the same distances, with about nprobe / nlist of the vector
// bytes.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kWarps = otbt::kThreads / 32;   // rows in flight per block
constexpr int kMaxK = 1024;                   // k above this: the sort
constexpr int kSelChunk = 128;                // rows a warp a step
constexpr int kSelQueue = 256;                // a warp's queue words
constexpr int kSelRowsPerBlock = 4096;        // at least, before the cap
constexpr unsigned long long kPadWord = ~0ull;

enum Metric { kL2 = 0, kCosine = 1, kIp = 2 };

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage q into qs[0, d) and |q|^2 into qs[d]; ends with a barrier.
__device__ __forceinline__ void stage_query(const float* __restrict__ q,
                                            int d, float* qs) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) qs[j] = q[j];
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int j = threadIdx.x; j < d; j += 32)
      s = __fadd_rn(s, __fmul_rn(qs[j], qs[j]));
    s = warp_sum(s);
    if (threadIdx.x == 0) qs[d] = s;
  }
  __syncthreads();
}

// v.q and |v|^2 of one row, summed over the warp (every lane gets both).
__device__ __forceinline__ void row_dot_norm(const float* __restrict__ v,
                                             const float* qs, int d, bool vec4,
                                             float& dot, float& vn2) {
  const int lane = threadIdx.x & 31;
  float a = 0.f, b = 0.f;
  if (vec4) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int j = lane; j < d / 4; j += 32) {
      float4 x = __ldg(v4 + j);
      float4 y = q4[j];
      a += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      b += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      float x = __ldg(v + j);
      a += x * qs[j];
      b += x * x;
    }
  }
  dot = warp_sum(a);
  vn2 = warp_sum(b);
}

// max(t, lo) that keeps a NaN, as torch.clamp_min and jnp.maximum do
// (CUDA's fmaxf returns the operand that is not NaN)
__device__ __forceinline__ float clamp_min_nan(float t, float lo) {
  return t > lo ? t : (t == t ? lo : t);
}

__device__ __forceinline__ float epilogue(int metric, float dot, float vn2,
                                          float qn2) {
  if (metric == kIp) return -dot;
  if (metric == kCosine) {
    float den = clamp_min_nan(__fmul_rn(sqrtf(vn2), sqrtf(qn2)), 1e-30f);
    return __fsub_rn(1.0f, __fdiv_rn(dot, den));
  }
  float t = __fadd_rn(__fsub_rn(vn2, __fmul_rn(2.0f, dot)), qn2);
  return sqrtf(clamp_min_nan(t, 0.0f));
}

__global__ void distances_kernel(const float* __restrict__ vecs,
                                 const float* __restrict__ q, long long n,
                                 int d, int metric, int vec4,
                                 float* __restrict__ out) {
  extern __shared__ float qs[];
  stage_query(q, d, qs);
  const float qn2 = qs[d];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n;
       r += stride) {
    float dot, vn2;
    row_dot_norm(vecs + r * d, qs, d, vec4 != 0, dot, vn2);
    if (lane == 0) out[r] = epilogue(metric, dot, vn2, qn2);
  }
}

__global__ void probe_scan_kernel(const float* __restrict__ vecs,
                                  const float* __restrict__ q,
                                  const int* __restrict__ assign,
                                  const bool* __restrict__ probed, int nlist,
                                  const bool* __restrict__ valid, long long n,
                                  int d, int metric, int vec4,
                                  float* __restrict__ out) {
  extern __shared__ float qs[];
  stage_query(q, d, qs);
  const float qn2 = qs[d];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n;
       r += stride) {
    int a = assign[r];
    a = a < 0 ? 0 : (a > nlist ? nlist : a);
    // warp-uniform: every lane reads the same row's flags
    float dist = INFINITY;
    if (valid[r] && probed[a]) {
      float dot, vn2;
      row_dot_norm(vecs + r * d, qs, d, vec4 != 0, dot, vn2);
      dist = epilogue(metric, dot, vn2, qn2);
    }
    if (lane == 0) out[r] = dist;
  }
}

// (order-preserving bits of x) << 32 | row: -0.0 ranks as 0.0, every
// NaN one step above +inf (0x7f800000 maps to 0xff800000)
__device__ __forceinline__ unsigned long long order_word(float x,
                                                         unsigned row) {
  unsigned k;
  if (x != x) {
    k = 0xff800001u;
  } else {
    if (x == 0.0f) x = 0.0f;
    const unsigned b = __float_as_uint(x);
    k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return ((unsigned long long)k << 32) | row;
}

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? b : a;
}

// Steps of a bitonic network over the warp's 32 E words in registers
// (word lane * E + e in v[e]): a compare-exchange at distance j,
// ascending where the word's index has bit k clear.  Across lanes (j >=
// E) by a shuffle; inside a lane (j < E, a constant once unrolled, so v
// stays in registers).
template <int E>
__device__ __forceinline__ void step_lanes(unsigned long long (&v)[E],
                                           int lane, int k, int j) {
  const int lj = j / E;
  const bool lower = (lane & lj) == 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const unsigned long long o = __shfl_xor_sync(kFull, v[e], lj);
    const bool asc = ((lane * E + e) & k) == 0;
    v[e] = asc == lower ? umin(v[e], o) : umax(v[e], o);
  }
}

template <int E>
__device__ __forceinline__ void step_regs(unsigned long long (&v)[E],
                                          int lane, int k, int j) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((e & j) == 0) {
      const bool asc = ((lane * E + e) & k) == 0;
      const unsigned long long x = v[e], y = v[e | j];
      v[e] = asc ? umin(x, y) : umax(x, y);
      v[e | j] = asc ? umax(x, y) : umin(x, y);
    }
  }
}

template <int E>
constexpr int kLog2 = E >= 8 ? 3 : E >= 4 ? 2 : E >= 2 ? 1 : 0;

// Ascending sort of a[0, 32 E) by one warp in registers (a bitonic
// sort: shuffles, no shared-memory round trips or barriers).
template <int E>
__device__ __forceinline__ void warp_sort_regs(unsigned long long* a,
                                               int lane) {
  constexpr int lg = kLog2<E> + 5;
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = a[lane * E + e];
#pragma unroll
  for (int lk = 1; lk <= lg; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      if ((1 << lj) >= E)
        step_lanes<E>(v, lane, 1 << lk, 1 << lj);
      else
        step_regs<E>(v, lane, 1 << lk, 1 << lj);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) a[lane * E + e] = v[e];
  __syncwarp();
}

// list[0, s) (sorted) <- the s smallest of list and b[0, p) (sorted),
// s <= 32 E (s = 32 E when E > 1), in registers: min(list[i], b[s - 1 -
// i]) is bitonic and holds them, then a bitonic merge sorts it (with s
// < 32 the lanes past s compute what nothing stores).
template <int E>
__device__ __forceinline__ void keep_smallest_regs(
    unsigned long long* list, const unsigned long long* b, int s, int p,
    int lane) {
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    v[e] = kPadWord;
    if (i < s) {
      v[e] = list[i];
      if (s - 1 - i < p) v[e] = umin(v[e], b[s - 1 - i]);
    }
  }
  for (int j = s >> 1; j >= E; j >>= 1) step_lanes<E>(v, lane, 2 * s, j);
#pragma unroll
  for (int lj = kLog2<E> - 1; lj >= 0; --lj)
    step_regs<E>(v, lane, 2 * s, 1 << lj);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane * E + e < s) list[lane * E + e] = v[e];
  __syncwarp();
}

// list[0, s) (sorted) <- the s smallest of list and b[0, p) (sorted),
// by one warp: min(list[i], b[s - 1 - i]) is bitonic and holds them,
// then a bitonic merge sorts it.
__device__ void warp_keep_smallest(unsigned long long* list,
                                   const unsigned long long* b, int s, int p,
                                   int lane) {
  for (int i = lane; i < s; i += 32) {
    const int j = s - 1 - i;
    if (j < p && b[j] < list[i]) list[i] = b[j];
  }
  __syncwarp();
  for (int j = s >> 1; j > 0; j >>= 1) {
    for (int t = lane; t < s / 2; t += 32) {
      const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      const int l = i + j;
      const unsigned long long x = list[i], y = list[l];
      if (x > y) {
        list[i] = y;
        list[l] = x;
      }
    }
    __syncwarp();
  }
}

// The queue's p <= kSelQueue words sorted in place (p a power of two).
__device__ void sort_queue(unsigned long long* q, int p, int lane) {
  if (p <= 32) warp_sort_regs<1>(q, lane);
  else if (p <= 64) warp_sort_regs<2>(q, lane);
  else if (p <= 128) warp_sort_regs<4>(q, lane);
  else warp_sort_regs<8>(q, lane);
}

// keep_smallest_regs for s <= 256, the shared-memory form above it.
__device__ void keep_smallest(unsigned long long* list,
                              const unsigned long long* b, int s, int p,
                              int lane) {
  if (s <= 32) keep_smallest_regs<1>(list, b, s, p, lane);
  else if (s <= 64) keep_smallest_regs<2>(list, b, s, p, lane);
  else if (s <= 128) keep_smallest_regs<4>(list, b, s, p, lane);
  else if (s <= 256) keep_smallest_regs<8>(list, b, s, p, lane);
  else warp_keep_smallest(list, b, s, p, lane);
}

int pow2_at_least(long long k) {
  int s = 1;
  while (s < k) s <<= 1;
  return s;
}

__device__ __forceinline__ int pow2_up(int k) {
  int s = 1;
  while (s < k) s <<= 1;
  return s;
}

// One warp's select: its s smallest words so far (sorted) in `list`, the
// words that passed the threshold in `queue`.
struct WarpSel {
  unsigned long long* list;
  unsigned long long* queue;
  int s, k, qc;
  bool merged;                  // the list holds a merge's result
  unsigned long long thr;       // list[k - 1]: a word must be below it

  __device__ void init(unsigned long long* base, int s_, int k_, int lane) {
    list = base;
    queue = base + s_;
    s = s_;
    k = k_;
    qc = 0;
    merged = false;
    thr = kPadWord;
    for (int i = lane; i < s; i += 32) list[i] = kPadWord;
    __syncwarp();
  }

  // The queue sorted and merged into the list; a new threshold.
  __device__ void flush(int lane) {
    if (qc == 0) return;
    const int p = pow2_up(qc < 32 ? 32 : qc);
    for (int i = qc + lane; i < p; i += 32) queue[i] = kPadWord;
    __syncwarp();
    sort_queue(queue, p, lane);
    keep_smallest(list, queue, s, p, lane);
    thr = list[k - 1];
    qc = 0;
    merged = true;
    __syncwarp();
  }

  // Lane `lane` offers w[0..3]: a word below the threshold joins the
  // queue; the queue is flushed when it could not take another chunk,
  // and after the first chunks that fill the list.
  __device__ void offer(const unsigned long long (&w)[4], int lane) {
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool take = w[u] < thr;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (take) queue[qc + __popc(m & lt)] = w[u];
      qc += __popc(m);
    }
    __syncwarp();
    if (qc > kSelQueue - kSelChunk || (!merged && qc >= s)) flush(lane);
  }
};

// The words of rows r0 .. r0 + 3 (kPadWord past n): a float4 of
// distances and four valid bytes where the chunk is whole and aligned.
__device__ __forceinline__ void row_words(const float* __restrict__ dist,
                                          const bool* __restrict__ valid,
                                          long long n, long long r0, bool vec,
                                          unsigned long long (&w)[4]) {
  float x[4];
  bool v[4] = {true, true, true, true};
  if (vec && r0 + 3 < n) {
    const float4 d4 = __ldg(reinterpret_cast<const float4*>(dist + r0));
    x[0] = d4.x;
    x[1] = d4.y;
    x[2] = d4.z;
    x[3] = d4.w;
    if (valid != nullptr) {
      const unsigned b =
          __ldg(reinterpret_cast<const unsigned*>(valid + r0));
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = ((b >> (8 * u)) & 0xffu) != 0;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = r0 + u < n ? dist[r0 + u] : 0.0f;
      if (valid != nullptr && r0 + u < n) v[u] = valid[r0 + u];
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    w[u] = r0 + u < n ? order_word(v[u] ? x[u] : INFINITY,
                                   (unsigned)(r0 + u))
                      : kPadWord;
}

// The block's warps' lists merged into warp 0's (a tree); ends with a
// barrier.
__device__ void block_merge(unsigned long long* sm, int s, int lane) {
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5;
  for (int st = 1; st < warps; st <<= 1) {
    __syncthreads();
    if (w % (2 * st) == 0 && w + st < warps)
      keep_smallest(sm + (long long)w * (s + kSelQueue),
                         sm + (long long)(w + st) * (s + kSelQueue), s, s,
                         lane);
  }
  __syncthreads();
}

// rows and masked distances of the k smallest words in list[0, k)
__device__ void write_topk(const unsigned long long* list, int k,
                          const float* __restrict__ dist,
                          const bool* __restrict__ valid,
                          long long* __restrict__ idx,
                          float* __restrict__ out) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const long long r = (long long)(list[i] & 0xffffffffull);
    idx[i] = r;
    out[i] = (valid == nullptr || valid[r]) ? dist[r] : INFINITY;
  }
}

// Block b: rows of the 128-row chunks b * warps + w, stepping by every
// warp of the grid; then its s words to cand[b * s, (b + 1) * s), and
// the last block selects again over all of cand.
__global__ void topk_select_kernel(const float* __restrict__ dist,
                                   const bool* __restrict__ valid,
                                   long long n, int k, int s,
                                   unsigned long long* __restrict__ cand,
                                   int* __restrict__ ticket,
                                   long long* __restrict__ idx,
                                   float* __restrict__ out) {
  extern __shared__ unsigned long long sm[];
  __shared__ int sh_last;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  WarpSel sel;
  sel.init(sm + (long long)w * (s + kSelQueue), s, k, lane);
  const bool vec =
      (((unsigned long long)dist) & 15ull) == 0 &&
      (valid == nullptr || (((unsigned long long)valid) & 3ull) == 0);
  const long long stride = (long long)gridDim.x * warps * kSelChunk;
  for (long long c0 = ((long long)blockIdx.x * warps + w) * kSelChunk;
       c0 < n; c0 += stride) {
    unsigned long long wd[4];
    row_words(dist, valid, n, c0 + 4 * lane, vec, wd);
    sel.offer(wd, lane);
  }
  sel.flush(lane);
  block_merge(sm, s, lane);
  if (gridDim.x == 1) {
    write_topk(sm, k, dist, valid, idx, out);
    return;
  }
  for (int i = threadIdx.x; i < s; i += blockDim.x)
    cand[(long long)blockIdx.x * s + i] = sm[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sh_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  // the last block: every block's s words through the same select
  sel.init(sm + (long long)w * (s + kSelQueue), s, k, lane);
  const long long m = (long long)gridDim.x * s;
  for (long long c0 = (long long)w * kSelChunk; c0 < m;
       c0 += (long long)warps * kSelChunk) {
    unsigned long long wd[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long c = c0 + 4 * lane + u;
      wd[u] = c < m ? __ldcg(cand + c) : kPadWord;
    }
    sel.offer(wd, lane);
  }
  sel.flush(lane);
  block_merge(sm, s, lane);
  write_topk(sm, k, dist, valid, idx, out);
}

// The select's launch: blocks, warps a block, shared bytes.
struct TopkLaunch {
  int blocks, warps;
  size_t smem;
};

TopkLaunch topk_launch(long long n, int k) {
  const int s = pow2_at_least(k);
  TopkLaunch L;
  L.warps = s <= 256 ? 8 : 4;
  L.smem = (size_t)L.warps * (s + kSelQueue) * sizeof(unsigned long long);
  long long want = (n + kSelRowsPerBlock - 1) / kSelRowsPerBlock;
  long long cap = 132LL * 2;
  if (65536 / s < cap) cap = 65536 / s;   // the last block's words
  if (want > cap) want = cap;
  L.blocks = (int)(want < 1 ? 1 : want);
  return L;
}

int rows_grid(long long n) {
  long long want = (n + kWarps - 1) / kWarps;
  const long long cap = 132LL * 16;
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

}  // namespace

// vecs: n x d f32 (row-major, contiguous); q: d f32; out: n f32.
// vec4 != 0: d % 4 == 0 and vecs 16-byte aligned.
extern "C" int otbt_ann_distances(const void* vecs, const void* q, long long n,
                                  int d, int metric, int vec4, void* out,
                                  void* stream) {
  if (n < 0 || d <= 0 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = (size_t)(d + 1) * sizeof(float);
  distances_kernel<<<rows_grid(n), otbt::kThreads, smem, st>>>(
      (const float*)vecs, (const float*)q, n, d, metric, vec4, (float*)out);
  return (int)cudaGetLastError();
}

// assign: n int32 list ids; probed: nlist + 1 bools (the last false);
// valid: n bools; out: n f32 (+inf where the row is not ranked).
extern "C" int otbt_ann_probe_scan(const void* vecs, const void* q,
                                   const void* assign, const void* probed,
                                   int nlist, const void* valid, long long n,
                                   int d, int metric, int vec4, void* out,
                                   void* stream) {
  if (n < 0 || d <= 0 || nlist < 0 || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = (size_t)(d + 1) * sizeof(float);
  probe_scan_kernel<<<rows_grid(n), otbt::kThreads, smem, st>>>(
      (const float*)vecs, (const float*)q, (const int*)assign,
      (const bool*)probed, nlist, (const bool*)valid, n, d, metric, vec4,
      (float*)out);
  return (int)cudaGetLastError();
}

// Scratch bytes of the top-k of n rows: the blocks' candidate words and
// the ticket (0 when one block does it all).
extern "C" long long otbt_ann_topk_scratch_bytes(long long n, int k) {
  if (k < 1 || k > kMaxK || n < k) return 0;
  const TopkLaunch L = topk_launch(n, k);
  if (L.blocks == 1) return 0;
  return (long long)L.blocks * pow2_at_least(k) * 8 + 16;
}

// dist: n f32; valid: n bools or null (every row valid); 1 <= k <= n,
// k <= kMaxK; scratch: otbt_ann_topk_scratch_bytes(n, k) bytes (8-byte
// aligned; its ticket is zeroed here, one memset); idx: k int64 rows;
// out: k f32 masked distances.  One launch.
extern "C" int otbt_ann_topk(const void* dist, const void* valid, long long n,
                             int k, void* scratch, long long scratch_bytes,
                             void* idx, void* out, void* stream) {
  if (k < 1 || k > kMaxK || (long long)k > n || n >= 0xffffffffLL ||
      scratch_bytes < otbt_ann_topk_scratch_bytes(n, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const TopkLaunch L = topk_launch(n, k);
  const int s = pow2_at_least(k);
  unsigned long long* cand = nullptr;
  int* ticket = nullptr;
  if (L.blocks > 1) {
    cand = (unsigned long long*)scratch;
    ticket = (int*)(cand + (long long)L.blocks * s);
    cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  topk_select_kernel<<<L.blocks, L.warps * 32, L.smem, st>>>(
      (const float*)dist, (const bool*)valid, n, k, s, cand, ticket,
      (long long*)idx, (float*)out);
  return (int)cudaGetLastError();
}
