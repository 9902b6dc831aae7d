// Codec decode and compare-on-codes over encoded staged columns.
//
// Replaces opentenbase_tpu/ops/kernels.py:55 decode_column and :69
// cmp_on_codes.  Bound: bytes.  Codes are read at their native width
// (uint8/16/32) and never widened in device memory; decode writes the
// original dtype (int32/int64), compare writes one byte a row.  One
// template covers code width x output dtype x codec family; the six
// compares are a runtime op code (uniform across a launch, so no warp
// diverges on it).
//
// Families (storage/codec.py): pack = plain downcast; for = code + (lo-1)
// with code 0 the padding sentinel, which decodes to exactly 0 so padded
// __xmax_ts rows stay 0; dict = LUT gather, code 0 -> LUT slot 0 (= 0).
// A dict code at or past the LUT capacity reads nothing and yields the
// dtype's minimum, as the reference's out-of-range take does.
#include "common.cuh"

namespace {

enum Family { kPack = 0, kFor = 1, kDict = 2 };
enum Op { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };

template <typename T> __device__ __forceinline__ T dtype_min();
template <> __device__ __forceinline__ int dtype_min<int>() {
  return (int)0x80000000;
}
template <> __device__ __forceinline__ long long dtype_min<long long>() {
  return (long long)0x8000000000000000ULL;
}

// Value of one code; `pad_select` is the decode path's "code 0 -> 0".
template <typename C, typename T, int FAM>
__device__ __forceinline__ T value_of(C code, const T* __restrict__ aux,
                                      long long cap, bool pad_select) {
  if (FAM == kPack) return (T)code;
  if (FAM == kFor) {
    if (pad_select && code == 0) return (T)0;
    return (T)((T)code + aux[0]);
  }
  return ((long long)code < cap) ? aux[code] : dtype_min<T>();
}

template <typename C, typename T, int FAM>
__global__ void decode_kernel(const C* __restrict__ codes,
                              const T* __restrict__ aux, long long cap,
                              T* __restrict__ out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = value_of<C, T, FAM>(codes[i], aux, cap, true);
  }
}

template <typename C, typename T, int FAM>
__global__ void cmp_kernel(const C* __restrict__ codes,
                           const T* __restrict__ aux, long long cap, int op,
                           T lit, bool* __restrict__ out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    T v = value_of<C, T, FAM>(codes[i], aux, cap, false);
    bool r;
    switch (op) {
      case kEq: r = v == lit; break;
      case kNe: r = v != lit; break;
      case kLt: r = v < lit; break;
      case kLe: r = v <= lit; break;
      case kGt: r = v > lit; break;
      default: r = v >= lit; break;
    }
    out[i] = r;
  }
}

template <typename C, typename T>
void launch_decode(int family, const void* codes, const void* aux,
                   long long cap, void* out, long long n, cudaStream_t s) {
  int g = otbt::grid_for(n);
  const C* c = (const C*)codes;
  const T* a = (const T*)aux;
  T* o = (T*)out;
  if (family == kPack)
    decode_kernel<C, T, kPack><<<g, otbt::kThreads, 0, s>>>(c, a, cap, o, n);
  else if (family == kFor)
    decode_kernel<C, T, kFor><<<g, otbt::kThreads, 0, s>>>(c, a, cap, o, n);
  else
    decode_kernel<C, T, kDict><<<g, otbt::kThreads, 0, s>>>(c, a, cap, o, n);
}

template <typename C, typename T>
void launch_cmp(int family, const void* codes, const void* aux, long long cap,
                int op, long long lit, void* out, long long n,
                cudaStream_t s) {
  int g = otbt::grid_for(n);
  const C* c = (const C*)codes;
  const T* a = (const T*)aux;
  bool* o = (bool*)out;
  T l = (T)lit;
  if (family == kPack)
    cmp_kernel<C, T, kPack><<<g, otbt::kThreads, 0, s>>>(c, a, cap, op, l, o,
                                                         n);
  else if (family == kFor)
    cmp_kernel<C, T, kFor><<<g, otbt::kThreads, 0, s>>>(c, a, cap, op, l, o,
                                                        n);
  else
    cmp_kernel<C, T, kDict><<<g, otbt::kThreads, 0, s>>>(c, a, cap, op, l, o,
                                                         n);
}

template <typename T>
int dispatch_code(bool is_cmp, int code_bits, int family, const void* codes,
                  const void* aux, long long cap, int op, long long lit,
                  void* out, long long n, cudaStream_t s) {
  switch (code_bits) {
    case 8:
      if (is_cmp) launch_cmp<uint8_t, T>(family, codes, aux, cap, op, lit, out, n, s);
      else launch_decode<uint8_t, T>(family, codes, aux, cap, out, n, s);
      return 0;
    case 16:
      if (is_cmp) launch_cmp<uint16_t, T>(family, codes, aux, cap, op, lit, out, n, s);
      else launch_decode<uint16_t, T>(family, codes, aux, cap, out, n, s);
      return 0;
    case 32:
      if (is_cmp) launch_cmp<uint32_t, T>(family, codes, aux, cap, op, lit, out, n, s);
      else launch_decode<uint32_t, T>(family, codes, aux, cap, out, n, s);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

int run(bool is_cmp, const void* codes, int code_bits, const void* aux,
        int out_bits, int family, long long cap, int op, long long lit,
        void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (family < kPack || family > kDict || op < kEq || op > kGe)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (out_bits == 32)
    rc = dispatch_code<int>(is_cmp, code_bits, family, codes, aux, cap, op,
                            lit, out, n, s);
  else if (out_bits == 64)
    rc = dispatch_code<long long>(is_cmp, code_bits, family, codes, aux, cap,
                                  op, lit, out, n, s);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int otbt_decode_column(const void* codes, int code_bits,
                                  const void* aux, int out_bits, int family,
                                  long long cap, void* out, long long n,
                                  void* stream) {
  return run(false, codes, code_bits, aux, out_bits, family, cap, 0, 0, out,
             n, stream);
}

extern "C" int otbt_cmp_on_codes(const void* codes, int code_bits,
                                 const void* aux, int out_bits, int family,
                                 long long cap, int op, long long lit,
                                 void* out, long long n, void* stream) {
  return run(true, codes, code_bits, aux, out_bits, family, cap, op, lit, out,
             n, stream);
}
