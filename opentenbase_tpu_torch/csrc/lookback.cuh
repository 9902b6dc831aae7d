// A single-pass decoupled look-back scan across thread blocks, shared by
// K13b's prefix scan (window.cu wfr_scan), K3's compaction (compact.cu),
// K8's pair expansion (join.cu expand_tiles) and K5's group numbering
// (groupsort.cu group_reduce).
//
// A block takes its tile from an atomic ticket (ctrl[0]), so every lower
// tile is already running and none waits on a tile that is not resident.
// It scans its own rows, publishes its aggregate, and warp 0 computes the
// tile's exclusive prefix.  Tiles form groups of 32.  A tile's exclusive
// prefix is S(g - 1) + P(g, j): S(h) is the left fold, group by group, of
// each group's sum G(h) (an ordered butterfly over the group's 32
// aggregates), published by the group's last tile; P(g, j) is a warp scan
// of the aggregates of the tiles below it in its own group.  Warp 0 takes
// the nearest published S(h) and adds the groups above it itself (8
// groups a round trip), so no tile waits on another tile's look-back,
// only on aggregates, which every tile publishes as soon as it has read
// its rows.  Each value has one definition, whichever path computed it:
// f64 sums are the same bits every run.  Status words are written with
// release and read relaxed, then a fence; the values beside them are read
// from L2.
//
// The scanned value is a pair (C, V): C a count (int, or Cnt4: a count
// and the NaN, +inf and -inf counts of an f64 argument), V a sum
// (NoSum; unsigned long long, which wraps as int64 does; SegF, an f64 sum
// restarted at each segment start: the segmented operator, the flag
// travelling with the value).  combine(a, b) takes a before b: SegF is
// not commutative, so every fold here keeps the row order.
#pragma once
#include <type_traits>

#include "common.cuh"

namespace otbt {
namespace lb {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

struct NoSum {};
struct alignas(16) Cnt4 {
  int c, nan, pinf, minf;
};
struct alignas(16) SegF {
  double s;
  int f;   // a segment starts in this span
  int pad;
};

__device__ __forceinline__ int combine(int a, int b) { return a + b; }
__device__ __forceinline__ unsigned long long combine(unsigned long long a,
                                                      unsigned long long b) {
  return a + b;
}
__device__ __forceinline__ Cnt4 combine(Cnt4 a, Cnt4 b) {
  Cnt4 r;
  r.c = a.c + b.c;
  r.nan = a.nan + b.nan;
  r.pinf = a.pinf + b.pinf;
  r.minf = a.minf + b.minf;
  return r;
}
__device__ __forceinline__ SegF combine(SegF a, SegF b) {
  SegF r;
  r.s = b.f ? b.s : a.s + b.s;
  r.f = a.f | b.f;
  r.pad = 0;
  return r;
}
__device__ __forceinline__ NoSum combine(NoSum, NoSum) { return NoSum{}; }

template <class T>
__device__ __forceinline__ T zero() {
  return T{};
}

// Warp shuffles of each value type (kind 0: up, 1: xor, 2: from lane).
template <int kKind, class X>
__device__ __forceinline__ X shfl_one(X v, int d) {
  if constexpr (kKind == 0) return __shfl_up_sync(kFull, v, d);
  else if constexpr (kKind == 1) return __shfl_xor_sync(kFull, v, d);
  else return __shfl_sync(kFull, v, d);
}
template <int kKind>
__device__ __forceinline__ int shfl(int v, int d) {
  return shfl_one<kKind>(v, d);
}
template <int kKind>
__device__ __forceinline__ unsigned long long shfl(unsigned long long v,
                                                   int d) {
  return shfl_one<kKind>(v, d);
}
template <int kKind>
__device__ __forceinline__ Cnt4 shfl(Cnt4 v, int d) {
  Cnt4 r;
  r.c = shfl_one<kKind>(v.c, d);
  r.nan = shfl_one<kKind>(v.nan, d);
  r.pinf = shfl_one<kKind>(v.pinf, d);
  r.minf = shfl_one<kKind>(v.minf, d);
  return r;
}
template <int kKind>
__device__ __forceinline__ SegF shfl(SegF v, int d) {
  SegF r;
  r.s = shfl_one<kKind>(v.s, d);
  r.f = shfl_one<kKind>(v.f, d);
  r.pad = 0;
  return r;
}
template <int kKind>
__device__ __forceinline__ NoSum shfl(NoSum v, int) {
  return v;
}

// L2 loads of a published value.
__device__ __forceinline__ int ldcg(const int* p) { return __ldcg(p); }
__device__ __forceinline__ unsigned long long ldcg(
    const unsigned long long* p) {
  return __ldcg(p);
}
__device__ __forceinline__ Cnt4 ldcg(const Cnt4* p) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
  Cnt4 r;
  r.c = v.x;
  r.nan = v.y;
  r.pinf = v.z;
  r.minf = v.w;
  return r;
}
__device__ __forceinline__ SegF ldcg(const SegF* p) {
  SegF r;
  r.s = __ldcg(&p->s);
  r.f = __ldcg(&p->f);
  r.pad = 0;
  return r;
}
__device__ __forceinline__ NoSum ldcg(const NoSum*) { return NoSum{}; }

// Inclusive scan across the warp in lane order.
template <class T>
__device__ __forceinline__ T warp_incl(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl<0>(v, d);
    if (lane >= d) v = combine(y, v);
  }
  return v;
}

// The warp's fold in lane order, the same bits in every lane: step d
// combines the lower half of each aligned 2d-lane block with its upper
// half, both lanes of a pair from the same operands.
template <class T>
__device__ __forceinline__ T warp_fold(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = shfl<1>(v, d);
    v = (lane & d) ? combine(o, v) : combine(v, o);
  }
  return v;
}

// One scan's look-back state in device memory (zeroed ctrl before the
// launch: one memset).
template <class C, class V>
struct Chain {
  int tiles;
  int* ctrl;   // [0] the next tile, [1 + t] tile t's aggregate published,
               // [1 + tiles + g] group g's S(g) published
  C* agg_c;    // per tile: its aggregate
  V* agg_s;
  C* grp_c;    // per group: S(g)
  V* grp_s;
};

// Control words of a chain over `tiles` tiles.
__host__ __device__ inline long long ctrl_words(long long tiles) {
  return 1 + tiles + (tiles + 31) / 32;
}

template <class V>
constexpr bool kHasSum = !std::is_same<V, NoSum>::value;

// The block's tile: one ticket, shared through *sh.
__device__ __forceinline__ int take_tile(int* ctrl, int* sh) {
  if (threadIdx.x == 0) *sh = atomicAdd(ctrl, 1);
  __syncthreads();
  return *sh;
}

// Thread 0: publish tile `tile`'s aggregate.
template <class C, class V>
__device__ __forceinline__ void publish(const Chain<C, V>& ch, int tile,
                                        C c, V s) {
  ch.agg_c[tile] = c;
  if constexpr (kHasSum<V>) ch.agg_s[tile] = s;
  st_release(ch.ctrl + 1 + tile, 1);
}

// The aggregates of tiles q[u] (those with use[u]): spin until each is
// published, one fence, then the values (all loads of a step in flight).
template <int kN, class C, class V>
__device__ __forceinline__ void load_aggs(const Chain<C, V>& ch, const int* q,
                                          const bool* use, C* c, V* s) {
  const int* flags = ch.ctrl + 1;
  int f[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) f[u] = use[u] ? ld_relaxed(flags + q[u]) : 1;
#pragma unroll
  for (int u = 0; u < kN; ++u)
    while (f[u] == 0) f[u] = ld_relaxed(flags + q[u]);
  __threadfence();
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    c[u] = use[u] ? ldcg(ch.agg_c + q[u]) : zero<C>();
    s[u] = zero<V>();
    if constexpr (kHasSum<V>)
      if (use[u]) s[u] = ldcg(ch.agg_s + q[u]);
  }
}

// Warp 0: the exclusive prefix (xc, xs) of tile `tile` whose own
// aggregate is (bc, bs); the last tile of a group also publishes S(g).
template <class C, class V>
__device__ __forceinline__ void look_back(const Chain<C, V>& ch, int tile,
                                          int lane, C bc, V bs, C& xc,
                                          V& xs) {
  const int g = tile >> 5, j = tile & 31;
  // the tiles of this group: lane l < j loads tile 32 g + l, lane j is
  // this tile
  C vc[1];
  V vs[1];
  {
    const int q[1] = {(g << 5) + lane};
    const bool use[1] = {lane < j};
    load_aggs<1, C, V>(ch, q, use, vc, vs);
    if (lane == j) {
      vc[0] = bc;
      vs[0] = bs;
    }
  }
  // P(g, j): an inclusive scan over (lane < j ? aggregate : 0), at lane
  // j - 1
  const C ic = warp_incl(lane < j ? vc[0] : zero<C>(), lane);
  const V is = warp_incl(lane < j ? vs[0] : zero<V>(), lane);
  C pc = shfl<2>(ic, j > 0 ? j - 1 : 0);
  V ps = shfl<2>(is, j > 0 ? j - 1 : 0);
  if (j == 0) {
    pc = zero<C>();
    ps = zero<V>();
  }
  // S(g - 1): the nearest published S(h), then G(h + 1) .. G(g - 1)
  const int* gflags = ch.ctrl + 1 + ch.tiles;
  int h = -1;
  for (int top = g - 1; top >= 0 && h < 0; top -= 32) {
    const int q = top - lane;
    const unsigned m = __ballot_sync(kFull, q >= 0 && ld_relaxed(gflags + q));
    if (m) h = top - (__ffs(m) - 1);
  }
  __threadfence();
  C sc = zero<C>();
  V ss = zero<V>();
  if (h >= 0) {
    sc = ldcg(ch.grp_c + h);
    if constexpr (kHasSum<V>) ss = ldcg(ch.grp_s + h);
  }
  for (int h0 = h + 1; h0 < g; h0 += 8) {
    int q[8];
    bool use[8];
    C gc[8];
    V gs[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      use[u] = h0 + u < g;
      q[u] = ((h0 + u) << 5) + lane;
    }
    load_aggs<8, C, V>(ch, q, use, gc, gs);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (h0 + u < g) {
        sc = combine(sc, warp_fold(gc[u], lane));
        ss = combine(ss, warp_fold(gs[u], lane));
      }
    }
  }
  xc = combine(sc, pc);
  xs = combine(ss, ps);
  if (j == 31) {   // S(g) = S(g - 1) + G(g)
    const C gc = warp_fold(vc[0], lane);
    const V gs = warp_fold(vs[0], lane);
    if (lane == 0) {
      ch.grp_c[g] = combine(sc, gc);
      if constexpr (kHasSum<V>) ch.grp_s[g] = combine(ss, gs);
      st_release((int*)gflags + g, 1);
    }
  }
}

}  // namespace lb
}  // namespace otbt
