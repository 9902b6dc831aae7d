// Fused scan-aggregate with a query axis: K14's one-pass fragment.
//
// Replaces the body of opentenbase_tpu/exec/fused.py:511 _build_program
// (:533 run) and :563 run_batch for a scan -> qual -> projection ->
// aggregate fragment whose groups are dense or absent (TPC-H Q1, Q6):
// there XLA fuses visibility, decode, qual, projection and the aggregate
// transition into one pass, and run_batch maps it with lax.map over K
// (snapshot, txid, literals) tuples.  Here one launch does all K.
//
// Per row, each needed column is loaded once at its encoded width and
// decoded on load as K2 decodes it (codec.cu); a small register program
// (bytecode emitted by exec/expr_compile.py emit_scan_agg) computes the
// aggregate inputs and the dense group id once, since projections do not
// depend on the masked literals; then, for each of the K queries, the
// MVCC visibility test against that query's snapshot and txid and the
// qual program over that query's literals decide whether the row folds
// into the query's table.
//
// Bound: bytes.  The fragment's needed columns at their encoded widths
// plus the four MVCC columns are read once; the per-query work is a few
// register compares.  Accumulation is K4's design (grouped_agg.cu): each
// block folds into a private shared-memory table of K x (A + 1) x G
// 8-byte words (the last of the A + 1 rows counts the group's rows),
// then merges it into the global table with one atomic per non-identity
// word; a table over the shared-memory budget folds into global memory
// directly.
//
// Exactness and determinism: every accumulator is an int64 (sums of
// integers and decimals, counts, min and max of integers; a sum that
// feeds an average is summed as an integer too and converted to f64 by
// the wrapper), so atomics in any order give the same bits, and a query
// answered alone equals the same query answered inside a batch.  The
// emitter declines aggregates over f64 values, so no float sum reaches
// this kernel.  Float arithmetic inside quals and projections rounds
// op by op (the _rn intrinsics, never contracted into FMAs), as the
// plain PyTorch version does.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 24;
constexpr int kMaxIns = 160;
constexpr int kMaxConsts = 48;
constexpr int kMaxAggs = 24;
constexpr int kMaxRegs = 64;
constexpr int kHeader = 16;

// op codes: ops/kernels.py FUSED_OPS
enum Op {
  LDCOL = 0, LDLIT, CONST, IADD, ISUB, IMUL, IDIV, IMOD, INEG, WRAP32,
  IMIN, IMAX, FADD, FSUB, FMUL, FDIV, FNEG, I2F, IEQ, INE, ILT, ILE, IGT,
  IGE, FEQ, FNE, FLT, FLE, FGT, FGE, AND, OR, NOT
};
enum Family { kRaw = -1, kPack = 0, kFor = 1, kDict = 2 };
enum Kind { kSigned = 0, kUnsigned = 1, kFloat = 2 };
enum Agg { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

struct Col {
  const void* p;
  const void* aux;
  long long cap;
  int bytes;
  int family;
  int kind;
  int aux_bits;
};

struct Ins {
  unsigned char op, dst, a, b;
};

struct Spec {
  int n_cols, n_sh, n_q, n_aggs, gid_reg, qual_reg, n_groups, n_lits;
  int mv[4];
  long long aborted_ts, n_rows;
  Col cols[kMaxCols];
  Ins ins[kMaxIns];
  long long consts[kMaxConsts];
  int agg_kind[kMaxAggs];
  int agg_reg[kMaxAggs];
  long long ident[kMaxAggs];
};

__device__ __forceinline__ unsigned long long load_u(const void* p,
                                                     int bytes, long long i) {
  switch (bytes) {
    case 1: return ((const unsigned char*)p)[i];
    case 2: return ((const unsigned short*)p)[i];
    case 4: return ((const unsigned int*)p)[i];
    default: return ((const unsigned long long*)p)[i];
  }
}

__device__ __forceinline__ long long load_s(const void* p, int bytes,
                                            long long i) {
  switch (bytes) {
    case 1: return ((const signed char*)p)[i];
    case 2: return ((const short*)p)[i];
    case 4: return ((const int*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

// One column value of row i as a register word: ints sign-extended to
// int64, f64 as its bit pattern.  Encoded columns decode as codec.cu's
// value_of with the padding select (code 0 -> 0 for for/dict).
__device__ __forceinline__ long long load_col(const Col& c, long long i) {
  if (c.family == kRaw) {
    if (c.kind == kFloat) return load_s(c.p, 8, i);
    if (c.kind == kUnsigned) return (long long)load_u(c.p, c.bytes, i);
    return load_s(c.p, c.bytes, i);
  }
  unsigned long long code = load_u(c.p, c.bytes, i);
  if (c.family == kPack)
    return c.aux_bits == 32 ? (long long)(int)(unsigned int)code
                            : (long long)code;
  if (c.family == kFor) {
    if (code == 0) return 0;
    if (c.aux_bits == 32)
      return (long long)(int)((unsigned int)code +
                              (unsigned int)((const int*)c.aux)[0]);
    return (long long)(code + (unsigned long long)((const long long*)c.aux)[0]);
  }
  if ((long long)code >= c.cap)
    return c.aux_bits == 32 ? (long long)(int)0x80000000
                            : (long long)0x8000000000000000ULL;
  return c.aux_bits == 32 ? (long long)((const int*)c.aux)[code]
                          : ((const long long*)c.aux)[code];
}

__device__ __forceinline__ double as_f(long long v) {
  return __longlong_as_double(v);
}
__device__ __forceinline__ long long as_i(double v) {
  return __double_as_longlong(v);
}

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Run instructions [lo, hi) over the register file of row i; `lit` is
// the query's literal row (LDLIT), null in the shared part.
__device__ __forceinline__ void run_prog(const Spec& s, int lo, int hi,
                                         long long* r, long long i,
                                         const long long* lit) {
  for (int p = lo; p < hi; ++p) {
    const Ins in = s.ins[p];
    const long long a = r[in.a], b = r[in.b];
    long long v;
    switch (in.op) {
      case LDCOL: v = load_col(s.cols[in.a], i); break;
      case LDLIT: v = lit[in.a]; break;
      case CONST: v = s.consts[in.a]; break;
      case IADD: v = (long long)((unsigned long long)a + (unsigned long long)b); break;
      case ISUB: v = (long long)((unsigned long long)a - (unsigned long long)b); break;
      case IMUL: v = (long long)((unsigned long long)a * (unsigned long long)b); break;
      case IDIV: v = b == 0 ? 0 : floordiv(a, b); break;
      case IMOD: v = b == 0 ? 0 : a % b; break;
      case INEG: v = (long long)(0ULL - (unsigned long long)a); break;
      case WRAP32: v = (long long)(int)(unsigned int)(unsigned long long)a; break;
      case IMIN: v = a < b ? a : b; break;
      case IMAX: v = a > b ? a : b; break;
      case FADD: v = as_i(__dadd_rn(as_f(a), as_f(b))); break;
      case FSUB: v = as_i(__dsub_rn(as_f(a), as_f(b))); break;
      case FMUL: v = as_i(__dmul_rn(as_f(a), as_f(b))); break;
      case FDIV: v = as_i(__ddiv_rn(as_f(a), as_f(b))); break;
      case FNEG: v = as_i(-as_f(a)); break;
      case I2F: v = as_i(__ll2double_rn(a)); break;
      case IEQ: v = a == b; break;
      case INE: v = a != b; break;
      case ILT: v = a < b; break;
      case ILE: v = a <= b; break;
      case IGT: v = a > b; break;
      case IGE: v = a >= b; break;
      case FEQ: v = as_f(a) == as_f(b); break;
      case FNE: v = as_f(a) != as_f(b); break;
      case FLT: v = as_f(a) < as_f(b); break;
      case FLE: v = as_f(a) <= as_f(b); break;
      case FGT: v = as_f(a) > as_f(b); break;
      case FGE: v = as_f(a) >= as_f(b); break;
      case AND: v = (a != 0) & (b != 0); break;
      case OR: v = (a != 0) | (b != 0); break;
      default: v = a == 0; break;   // NOT
    }
    r[in.dst] = v;
  }
}

__device__ __forceinline__ void fold(unsigned long long* slot, int kind,
                                     long long v) {
  if (kind == kSum || kind == kCount)
    atomicAdd(slot, (unsigned long long)v);
  else if (kind == kMin)
    atomicMin((long long*)slot, v);
  else
    atomicMax((long long*)slot, v);
}

__global__ void fused_scan_agg_kernel(Spec s, const long long* __restrict__ lits,
                                      const long long* __restrict__ snaps,
                                      const long long* __restrict__ txids,
                                      int K, unsigned long long* __restrict__ ws,
                                      bool private_table) {
  extern __shared__ unsigned long long smem[];
  const int G = s.n_groups, A = s.n_aggs;
  const int per_q = (A + 1) * G;
  const int slots = K * per_q;
  unsigned long long* acc = private_table ? smem : ws;
  if (private_table) {
    for (int t = threadIdx.x; t < slots; t += blockDim.x) {
      int a = (t % per_q) / G;
      smem[t] = a < A ? (unsigned long long)s.ident[a] : 0ULL;
    }
    __syncthreads();
  }
  long long r[kMaxRegs];
  const int q_lo = s.n_sh, q_hi = s.n_sh + s.n_q;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < s.n_rows; i += stride) {
    run_prog(s, 0, s.n_sh, r, i, nullptr);
    long long g = s.gid_reg >= 0 ? r[s.gid_reg] : 0;
    if (g < 0 || g >= G) continue;
    const long long xmin = r[s.mv[0]], xmax = r[s.mv[1]];
    const long long xmin_tx = r[s.mv[2]], xmax_tx = r[s.mv[3]];
    for (int k = 0; k < K; ++k) {
      const long long snap = snaps[k], tx = txids[k];
      bool ins = (xmin <= snap) || ((xmin_tx == tx) && (xmin != s.aborted_ts));
      bool dele = (xmax <= snap) || (xmax_tx == tx);
      if (!ins || dele) continue;
      if (s.qual_reg >= 0) {
        run_prog(s, q_lo, q_hi, r, i, lits + (long long)k * s.n_lits);
        if (r[s.qual_reg] == 0) continue;
      }
      unsigned long long* t = acc + (long long)k * per_q + g;
      for (int a = 0; a < A; ++a) {
        int kind = s.agg_kind[a];
        fold(t + (long long)a * G, kind, kind == kCount ? 1 : r[s.agg_reg[a]]);
      }
      atomicAdd(t + (long long)A * G, 1ULL);
    }
  }
  if (!private_table) return;
  __syncthreads();
  for (int t = threadIdx.x; t < slots; t += blockDim.x) {
    int a = (t % per_q) / G;
    unsigned long long v = smem[t];
    if (a == A) {
      if (v) atomicAdd(ws + t, v);
      continue;
    }
    if (v == (unsigned long long)s.ident[a]) continue;
    fold(ws + t, s.agg_kind[a], (long long)v);
  }
}

}  // namespace

// spec: a flat int64 HOST array (ops/kernels.py _fused_spec): a 16-word
// header (n_cols, n_sh, n_q, n_aggs, gid_reg, qual_reg, n_groups, n_lits,
// n_consts, mv[4], aborted_ts, n_rows, 0), then 7 words a column (codes
// or raw pointer, aux pointer, aux capacity, bytes, family, kind,
// aux_bits), 4 an instruction (op, dst, a, b), the constants, and 3 an
// aggregate (kind, register, identity).  lits: K x n_lits int64,
// snaps / txids: K int64, all device memory; ws: K x (n_aggs + 1) x
// n_groups words on the device, already set to the identities.
extern "C" int otbt_fused_scan_agg(const long long* spec, long long spec_len,
                                   const void* lits, const void* snaps,
                                   const void* txids, int K, void* ws,
                                   void* stream) {
  if (spec_len < kHeader || K < 1) return (int)cudaErrorInvalidValue;
  Spec s;
  s.n_cols = (int)spec[0];
  s.n_sh = (int)spec[1];
  s.n_q = (int)spec[2];
  s.n_aggs = (int)spec[3];
  s.gid_reg = (int)spec[4];
  s.qual_reg = (int)spec[5];
  s.n_groups = (int)spec[6];
  s.n_lits = (int)spec[7];
  int n_consts = (int)spec[8];
  for (int j = 0; j < 4; ++j) s.mv[j] = (int)spec[9 + j];
  s.aborted_ts = spec[13];
  s.n_rows = spec[14];
  if (s.n_cols < 0 || s.n_cols > kMaxCols || s.n_sh < 0 || s.n_q < 0 ||
      s.n_sh + s.n_q > kMaxIns || n_consts < 0 || n_consts > kMaxConsts ||
      s.n_aggs < 0 || s.n_aggs > kMaxAggs || s.n_groups < 1 ||
      s.gid_reg >= kMaxRegs || s.qual_reg >= kMaxRegs ||
      s.n_lits < 0 || s.n_lits > kMaxRegs)
    return (int)cudaErrorInvalidValue;
  long long want = kHeader + 7LL * s.n_cols + 4LL * (s.n_sh + s.n_q) +
                   n_consts + 3LL * s.n_aggs;
  if (spec_len != want) return (int)cudaErrorInvalidValue;
  const long long* p = spec + kHeader;
  for (int c = 0; c < kMaxCols; ++c) {
    Col& col = s.cols[c];
    if (c < s.n_cols) {
      col.p = (const void*)p[0];
      col.aux = (const void*)p[1];
      col.cap = p[2];
      col.bytes = (int)p[3];
      col.family = (int)p[4];
      col.kind = (int)p[5];
      col.aux_bits = (int)p[6];
      p += 7;
    } else {
      col = Col{nullptr, nullptr, 0, 8, kRaw, kSigned, 64};
    }
  }
  for (int j = 0; j < kMaxIns; ++j) {
    Ins in{0, 0, 0, 0};
    if (j < s.n_sh + s.n_q) {
      for (int f = 0; f < 4; ++f)
        if (p[f] < 0 || p[f] >= 256) return (int)cudaErrorInvalidValue;
      in = Ins{(unsigned char)p[0], (unsigned char)p[1], (unsigned char)p[2],
               (unsigned char)p[3]};
      if (in.op > NOT || in.dst >= kMaxRegs || in.a >= kMaxRegs ||
          in.b >= kMaxRegs ||
          (in.op == LDCOL && in.a >= s.n_cols) ||
          (in.op == CONST && in.a >= n_consts) ||
          (in.op == LDLIT && in.a >= s.n_lits))
        return (int)cudaErrorInvalidValue;
      p += 4;
    }
    s.ins[j] = in;
  }
  for (int j = 0; j < kMaxConsts; ++j) s.consts[j] = j < n_consts ? *p++ : 0;
  for (int a = 0; a < kMaxAggs; ++a) {
    if (a < s.n_aggs) {
      s.agg_kind[a] = (int)p[0];
      s.agg_reg[a] = (int)p[1];
      s.ident[a] = p[2];
      if (s.agg_reg[a] < 0 || s.agg_reg[a] >= kMaxRegs)
        return (int)cudaErrorInvalidValue;
      p += 3;
    } else {
      s.agg_kind[a] = kSum;
      s.agg_reg[a] = 0;
      s.ident[a] = 0;
    }
  }
  if (s.n_rows <= 0) return (int)cudaGetLastError();
  size_t smem = (size_t)K * (size_t)(s.n_aggs + 1) * (size_t)s.n_groups * 8;
  bool private_table = smem <= 200 * 1024;
  if (private_table && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_scan_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_scan_agg_kernel<<<otbt::grid_for(s.n_rows, 4), otbt::kThreads,
                          private_table ? smem : 0, (cudaStream_t)stream>>>(
      s, (const long long*)lits, (const long long*)snaps,
      (const long long*)txids, K, (unsigned long long*)ws, private_table);
  return (int)cudaGetLastError();
}
