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
// 1 - v.q / max(|v| |q|, 1e-30), ip -v.q.
//
// Top-k.  The k smallest (distance, row) pairs, in the order of
// lax.top_k(-masked, k): ascending distance, ties to the lower row,
// masked rows as +inf.  Each pair packs into one u64 word (the f32's
// order-preserving bits above the row), so the order is a plain integer
// order and total.  Pass 1: every block keeps the S = pow2(k) smallest
// words of its row range in shared memory, merging tiles of fresh words
// by a bitonic sort of the whole buffer.  Pass 2: one block does the
// same over the blocks' candidates and writes rows and distances.  Bound:
// bytes (n distances and masks read once); the sorts are the simple
// correct first version.
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
constexpr int kSelBuf = 2048;                 // top-k buffer words
constexpr int kMaxK = 1024;                   // k above this: the sort
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

__device__ __forceinline__ float epilogue(int metric, float dot, float vn2,
                                          float qn2) {
  if (metric == kIp) return -dot;
  if (metric == kCosine) {
    float den = fmaxf(__fmul_rn(sqrtf(vn2), sqrtf(qn2)), 1e-30f);
    return __fsub_rn(1.0f, __fdiv_rn(dot, den));
  }
  float t = __fadd_rn(__fsub_rn(vn2, __fmul_rn(2.0f, dot)), qn2);
  return sqrtf(fmaxf(t, 0.0f));
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

// (order-preserving bits of x) << 32 | row; -0.0 ranks as 0.0
__device__ __forceinline__ unsigned long long order_word(float x,
                                                         unsigned row) {
  if (x == 0.0f) x = 0.0f;
  unsigned b = __float_as_uint(x);
  unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)k << 32) | row;
}

// Ascending bitonic sort of buf[0, m), m a power of two; all threads of
// the block call it; ends with a barrier.
__device__ void block_sort(unsigned long long* buf, int m) {
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < m / 2; t += blockDim.x) {
        int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        int l = i + j;
        unsigned long long a = buf[i], b = buf[l];
        bool asc = (i & k) == 0;
        if ((a > b) == asc) {
          buf[i] = b;
          buf[l] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Pass 1: block b keeps the s smallest words of rows [b*per, (b+1)*per).
__global__ void topk_block_kernel(const float* __restrict__ dist,
                                  const bool* __restrict__ valid, long long n,
                                  long long per, int s,
                                  unsigned long long* __restrict__ cand) {
  __shared__ unsigned long long buf[kSelBuf];
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = lo + per < n ? lo + per : n;
  for (int i = threadIdx.x; i < s; i += blockDim.x) buf[i] = kPadWord;
  const int fresh = kSelBuf - s;
  for (long long base = lo; base < hi; base += fresh) {
    for (int i = threadIdx.x; i < fresh; i += blockDim.x) {
      long long r = base + i;
      unsigned long long w = kPadWord;
      if (r < hi) {
        float x = (valid == nullptr || valid[r]) ? dist[r] : INFINITY;
        w = order_word(x, (unsigned)r);
      }
      buf[s + i] = w;
    }
    __syncthreads();
    block_sort(buf, kSelBuf);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s; i += blockDim.x)
    cand[(long long)blockIdx.x * s + i] = buf[i];
}

// Pass 2 (one block): the k smallest of m candidate words -> rows and
// their masked distances.
__global__ void topk_merge_kernel(const unsigned long long* __restrict__ cand,
                                  long long m, int s, int k,
                                  const float* __restrict__ dist,
                                  const bool* __restrict__ valid,
                                  long long* __restrict__ idx,
                                  float* __restrict__ out) {
  __shared__ unsigned long long buf[kSelBuf];
  for (int i = threadIdx.x; i < s; i += blockDim.x) buf[i] = kPadWord;
  const int fresh = kSelBuf - s;
  for (long long base = 0; base < m; base += fresh) {
    for (int i = threadIdx.x; i < fresh; i += blockDim.x) {
      long long c = base + i;
      buf[s + i] = c < m ? cand[c] : kPadWord;
    }
    __syncthreads();
    block_sort(buf, kSelBuf);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    long long r = (long long)(buf[i] & 0xffffffffull);
    idx[i] = r;
    out[i] = (valid == nullptr || valid[r]) ? dist[r] : INFINITY;
  }
}

int pow2_at_least(int k) {
  int s = 1;
  while (s < k) s <<= 1;
  return s;
}

// blocks of pass 1: enough to fill the card, fewer as k grows so that
// pass 2 merges a bounded number of candidates
long long topk_blocks(long long n, int k) {
  int s = pow2_at_least(k);
  long long fresh = kSelBuf - s;
  long long want = (n + fresh - 1) / fresh;
  long long cap = 132LL * 2;
  long long by_k = 65536 / s;
  if (by_k < cap) cap = by_k;
  if (want > cap) want = cap;
  return want < 1 ? 1 : want;
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

// u64 candidate words the top-k of n rows needs as scratch
extern "C" long long otbt_ann_topk_scratch(long long n, int k) {
  if (k < 1 || k > kMaxK) return 0;
  return topk_blocks(n, k) * pow2_at_least(k);
}

// dist: n f32; valid: n bools or null (every row valid); 1 <= k <= n,
// k <= kMaxK; cand: otbt_ann_topk_scratch(n, k) u64; idx: k int64 rows;
// out: k f32 masked distances.
extern "C" int otbt_ann_topk(const void* dist, const void* valid, long long n,
                             int k, void* cand, void* idx, void* out,
                             void* stream) {
  if (k < 1 || k > kMaxK || (long long)k > n || n >= 0xffffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int s = pow2_at_least(k);
  long long blocks = topk_blocks(n, k);
  long long per = (n + blocks - 1) / blocks;
  topk_block_kernel<<<(int)blocks, otbt::kThreads, 0, st>>>(
      (const float*)dist, (const bool*)valid, n, per, s,
      (unsigned long long*)cand);
  topk_merge_kernel<<<1, otbt::kThreads, 0, st>>>(
      (const unsigned long long*)cand, blocks * s, s, k, (const float*)dist,
      (const bool*)valid, (long long*)idx, (float*)out);
  return (int)cudaGetLastError();
}
