// K2's kernels, shared by the translation units that instantiate them:
// csrc/ell_spmv.cu (full-precision values and the pack) and
// csrc/ell_spmv_bf16.cu (bf16 values), built apart so that the two compile
// in parallel.
//
// ELL sparse matrix-vector product for Hopper (sm_90a): K2, in two forms.
//
// Replaces tpusolve/matrix/spmv.py:74 ell_spmv_local (an XLA fusion in
// tpusolve, not a Pallas kernel), the compute half of _spmv_shard_ell
// (:223) and of _offd_add's ghost term (:133).  For every row i
//
//     (A x)[i] = sum_k vals[i, k] * x[cols[i, k]]
//
// with each f32 row's products kept exact and the row rounded once (Sum
// below): a row of a Laplacian-like operator cancels to near zero, and f32
// partial sums give each row an error of the diagonal's size, which a
// single-precision Krylov solve then carries into the smooth error mode
// (gate 3 in `single`).
//
// with the operator stored in one of two forms:
//   * padded: (rows, K) values and int32 columns, row-major; a padded slot
//     holds value 0 and column 0, a padded row only padded slots (y is 0
//     there, as in the plain version, x[0] finite);
//   * row-pointer: rowptr (rows + 1, int32 or int64), values and int32
//     columns (nnz,), row i's entries at [rowptr[i], rowptr[i + 1]) in the
//     padded form's slot order, so that a row sums its entries in the same
//     order in either form (the same bits at the same G).
// The operator may be rectangular (the AMG transfers P and R): x has its
// own length, never read past the largest column.
//
// Two update forms, one launch each, as K1 (csrc/dia_spmv.cu):
//   * y = A x;
//   * y = c + w * s (.) (b - A x), any of b, s, c absent (a null pointer:
//     b = 0, s = 1, c = 0), computed as the plain version computes it
//     (tpusolve_torch/kernels/dia.py: epilogue_plain): t = b - A x (or A x
//     without b), t = (w s) t, then c + t (c - t without b).  y may be c
//     (the AMG prolongation x + P e is written into x in place): the one
//     thread that writes y[i] reads c[i] first.  y must not be x, b or s.
//
// What bounds it: bytes, two flops an entry, far below the card's rate for
// the operations.  The padded form moves (itemsize + 4) * rows * K bytes
// plus x and y, the row-pointer form (itemsize + 4) * nnz + the row
// pointer plus x and y: on a prolongation with 2.2 entries in K = 8 slots a
// row, 2.5x fewer (kernels/ell.py prices both; matrix/sharded.py keeps the
// cheaper form).  Design:
//   * G threads a row (G = 1 .. 32, a power of two chosen by the caller:
//     kernels/ell.py k2_plan / k2_rowptr_plan); lane g sums entries g,
//     g + G, g + 2G, ... of its row in order, kStage of them loaded before
//     their x entries are gathered through the read-only path (__ldg) and
//     multiplied and added (one fused multiply-add each), then the G
//     partial sums meet by a shuffle tree in a fixed order (no atomics):
//     the same bits in every run, and in both forms at the same G;
//   * padded form: the G lanes of a row read consecutive slots of the
//     row-major arrays, so a warp's loads are contiguous runs of G slots;
//   * row-pointer form: the same loop over [rowptr[i], rowptr[i + 1])
//     straight from device memory.  Rows are short and ragged (1 to 8
//     entries, 2.2 on average, on P), but a warp's 32 adjacent rows span
//     one contiguous run of entries, so its loads share a few sectors.  A
//     staged design (a block's span of entries copied into shared memory
//     by cp.async.bulk on an mbarrier, then gathered from there) measured
//     1.04-1.56x this kernel's time on every ELL operator of the BoomerAMG
//     paths on the H100 (the copy must land before any gather, so a block
//     pays both latencies in turn; PERF.md), and was dropped;
//   * lane 0 of the row applies the epilogue and writes y.
//
// The k-column form (the coupled multi-component solve, 2 <= k <= 8
// columns, KC a template parameter): one launch reads the operator once
// for k vectors.  What bounds it is the gathers, not the operator's
// bytes: in the solver's (k, n) layout each column's x entry is a gather
// of its own, and k of them a stored entry took 0.154 ms on gate 4's
// A_lo at k = 3, where one column takes 0.069 and the values and columns
// alone would take 0.057 (H100, PERF.md).  So x is packed first (one
// launch of ell_pack_kernel, x[j][i] to xp[i * k + j]) and the k columns
// of a stored entry's x are k adjacent loads, mostly of one sector.  Each
// lane keeps k accumulators (the single form's Sum at the same G), loads a
// stage's values and columns once, then all of its stage's k x entries,
// and then adds each column's products in the single form's order; the
// shuffle tree combines each column in the single form's fixed order:
// column j of a launch is the single-vector kernel on column j bit for
// bit.  y, b and c stay in the solver's layout, column j at j * ys_c (s is
// one vector for all columns).  On gate 4's 96^3 A_lo at k = 3 the launch
// on the packed x takes 0.104 ms and the pack 0.007; x packed to whole
// 16-byte units (4 columns) and read by vector loads took 0.109 and 0.005,
// and on the f64 A 0.141 and 0.018 against 0.128 and 0.017; one thread a
// row, keeping the row's G lanes' sums and their shuffle tree in
// registers (so that a warp's gathers of one slot are 32 rows', side by
// side on a banded operator), with the block's values and columns staged
// in shared memory, took 0.115 on A_lo and 0.158 on A (calibrate --kcols,
// PERF.md).  The bound: values and columns once, plus k times x and y;
// the pack adds 2k x entries a row of x.
//
// The bfloat16 value form (the smoother twin, smoother_dtype: bfloat16;
// V = uint16_t holds a bf16's bits, in the k-column form too): each value
// is converted exactly to x's type (f32 or f64) and multiplied and added
// in it, as JAX promotes bf16 * f32, so the launch equals the
// full-precision kernel on the values rounded to bf16 bit for bit.  A
// padded row of K = 27 bf16
// values is 54 bytes: the loads are two-byte scalar loads, which need no
// alignment.
//
// Each translation unit is built with nvcc into a shared library with a
// plain C interface and bound with ctypes (tpusolve_torch/kernels/build.py).
// Each entry point launches on the caller's stream, does not synchronise,
// and returns the value of cudaGetLastError() after the launch (0 on
// success).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kStage = 4;      // entries a lane loads before its adds
constexpr int kMaxCols = 8;    // columns of the k-column form, at most

// How a row of f32 products is summed (TPUSOLVE_K2_F32_SUM, a build flag
// that kernels/calibrate.py --k2-sum sets to compare them): 0 in f32, each
// product and partial sum rounded (K2's sums before the golden-check
// repair); 1 in double, each product exact, the row rounded once; 2 in
// compensated f32, each product's rounding error kept by an FMA and each
// add's by TwoSum (Knuth), the pair rounded once; 3, the port's, 2 at one
// thread a row and 1 at more, where each measured the faster (PERF.md):
// both give the f64 product's error.  The choice rests on G alone, so the
// k-column, bf16 and both storage forms keep the single form's bits.  f64
// operands are summed in f64 in every build.
#ifndef TPUSOLVE_K2_F32_SUM
#define TPUSOLVE_K2_F32_SUM 3
#endif

// a partial sum of products in T
template <typename T>
struct PlainSum {
  T s;
  __device__ __forceinline__ void zero() { s = T(0); }
  __device__ __forceinline__ void add(T v, T x) { s = fma(v, x, s); }
  __device__ __forceinline__ void add(const PlainSum& o) { s += o.s; }
  __device__ __forceinline__ PlainSum down(int off, int width) const {
    return PlainSum{__shfl_down_sync(0xffffffffu, s, off, width)};
  }
  __device__ __forceinline__ T value() const { return s; }
};

// a partial sum of f32 products in double
struct WideSum {
  double s;
  __device__ __forceinline__ void zero() { s = 0.0; }
  __device__ __forceinline__ void add(float v, float x) {
    s = fma((double)v, (double)x, s);
  }
  __device__ __forceinline__ void add(const WideSum& o) { s += o.s; }
  __device__ __forceinline__ WideSum down(int off, int width) const {
    return WideSum{__shfl_down_sync(0xffffffffu, s, off, width)};
  }
  __device__ __forceinline__ float value() const { return (float)s; }
};

// a partial sum of f32 products as s + c, c the errors of the products and
// adds so far; the _rn intrinsics keep nvcc from contracting them into
// FMAs, which would break the error terms
struct CompSum {
  float s, c;
  __device__ __forceinline__ void zero() { s = c = 0.0f; }
  __device__ __forceinline__ void two_sum(float a) {
    const float t = __fadd_rn(s, a);
    const float ap = __fsub_rn(t, s);
    const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, ap)),
                              __fsub_rn(a, ap));
    s = t;
    c = __fadd_rn(c, e);
  }
  __device__ __forceinline__ void add(float v, float x) {
    const float p = __fmul_rn(v, x);
    c = __fadd_rn(c, fmaf(v, x, -p));
    two_sum(p);
  }
  __device__ __forceinline__ void add(const CompSum& o) {
    c = __fadd_rn(c, o.c);
    two_sum(o.s);
  }
  __device__ __forceinline__ CompSum down(int off, int width) const {
    return CompSum{__shfl_down_sync(0xffffffffu, s, off, width),
                   __shfl_down_sync(0xffffffffu, c, off, width)};
  }
  __device__ __forceinline__ float value() const { return __fadd_rn(s, c); }
};

// the partial sum of a row of f32 operands at G threads a row
template <int G>
using F32Sum = typename std::conditional<
    TPUSOLVE_K2_F32_SUM == 0, PlainSum<float>,
    typename std::conditional<TPUSOLVE_K2_F32_SUM == 1 ||
                                  (TPUSOLVE_K2_F32_SUM == 3 && G > 1),
                              WideSum, CompSum>::type>::type;

// the partial sum of a row of T operands at G threads a row
template <typename T, int G>
using Sum = typename std::conditional<std::is_same<T, float>::value,
                                      F32Sum<G>, PlainSum<T>>::type;

template <typename T>
struct Epilogue {
  const T* b;
  const T* s;
  const T* c;
  T w;
};

// a value of type V as T: T itself, or a bf16's bits (uint16_t) widened
// exactly
template <typename T, typename V>
__device__ __forceinline__ T load_val(const V* p) {
  if constexpr (std::is_same<V, uint16_t>::value) {
    return (T)__uint_as_float((uint32_t)__ldg(p) << 16);
  } else {
    return __ldg(p);
  }
}

// lane's partial sums, one a column, of the entries [beg + lane, end) step
// G of a row whose values and columns are v[k], c[k], read through the
// read-only path; x is one column (KC = 1), else packed (entry q's KC
// columns side by side at x + q * KC); each sum kept as Sum<T, G>.  A
// stage's loads all issue before its adds.  An entry past the row adds 0
// * 0 in every column, as in the single form
template <typename T, typename V, int G, int KC>
__device__ __forceinline__ void row_sums(const V* __restrict__ v,
                                         const int* __restrict__ c,
                                         int64_t beg, int64_t end, int lane,
                                         const T* __restrict__ x,
                                         Sum<T, G> (&acc)[KC]) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    acc[j].zero();
  }
  for (int64_t k0 = beg + lane; k0 < end; k0 += G * kStage) {
    T vv[kStage];
    int cc[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int64_t k = k0 + s * G;
      vv[s] = T(0);
      cc[s] = 0;
      if (k < end) {
        vv[s] = load_val<T, V>(v + k);
        cc[s] = __ldg(c + k);
      }
    }
    if constexpr (KC == 1) {
      T xv[kStage];
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        xv[s] = k0 + s * G < end ? __ldg(x + cc[s]) : T(0);
      }
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        acc[0].add(vv[s], xv[s]);
      }
    } else {
      T xv[kStage][KC];
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const T* xs = x + (int64_t)cc[s] * KC;
        const bool in = k0 + s * G < end;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          xv[s][j] = in ? __ldg(xs + j) : T(0);
        }
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
          acc[j].add(vv[s], xv[s][j]);
        }
      }
    }
  }
}

// x (KC, n), column j at x + j * xs_c, packed: xp[i * KC + j] = x[j][i];
// one thread an entry i
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
ell_pack_kernel(const T* __restrict__ x, int64_t xs_c, int64_t n, T* xp) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) {
    return;
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    xp[i * KC + j] = x[j * xs_c + i];
  }
}

// each column's G partial sums of a row meet in lane 0, which applies the
// epilogue and writes y[j][i]; every lane of the warp takes part in the
// shuffles, rows past the end too (their sums are zero and never written)
template <typename T, int G, int KC>
__device__ __forceinline__ void finish_row(Sum<T, G> (&acc)[KC], bool valid,
                                           int lane, int64_t i, T* y,
                                           int64_t ys_c,
                                           const Epilogue<T>& ep) {
  if constexpr (G > 1) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2) {
        acc[j].add(acc[j].down(off, G));
      }
    }
  }
  if (!valid || lane != 0) {
    return;
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int64_t o = j * ys_c + i;
    T a = acc[j].value();
    if (ep.b != nullptr || ep.s != nullptr || ep.c != nullptr) {
      T t = ep.b != nullptr ? ep.b[o] - a : a;
      t = ep.s != nullptr ? (ep.w * ep.s[i]) * t : ep.w * t;
      if (ep.c != nullptr) {
        t = ep.b != nullptr ? ep.c[o] + t : ep.c[o] - t;
      } else if (ep.b == nullptr) {
        t = -t;
      }
      a = t;
    }
    y[o] = a;
  }
}

template <typename T, typename V, int G, int KC>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const V* __restrict__ vals, const int* __restrict__ cols,
                const T* __restrict__ x, T* y, int64_t rows, int K,
                int64_t ys_c, const Epilogue<T> ep) {
  constexpr int RB = kThreads / G;  // rows a block
  const int lane = threadIdx.x % G;
  const int64_t i = (int64_t)blockIdx.x * RB + threadIdx.x / G;
  const bool valid = i < rows;
  Sum<T, G> acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    acc[j].zero();
  }
  if (valid) {
    row_sums<T, V, G, KC>(vals + i * K, cols + i * K, 0, K, lane, x, acc);
  }
  finish_row<T, G, KC>(acc, valid, lane, i, y, ys_c, ep);
}

template <typename T, typename V, typename I, int G, int KC>
__global__ void __launch_bounds__(kThreads)
ell_rowptr_kernel(const I* __restrict__ rowptr, const V* __restrict__ vals,
                  const int* __restrict__ cols, const T* __restrict__ x,
                  T* y, int64_t rows, int64_t ys_c,
                  const Epilogue<T> ep) {
  constexpr int RB = kThreads / G;  // rows a block
  const int lane = threadIdx.x % G;
  const int64_t i = (int64_t)blockIdx.x * RB + threadIdx.x / G;
  const bool valid = i < rows;
  Sum<T, G> acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    acc[j].zero();
  }
  if (valid) {
    row_sums<T, V, G, KC>(vals, cols, (int64_t)__ldg(rowptr + i),
                          (int64_t)__ldg(rowptr + i + 1), lane, x, acc);
  }
  finish_row<T, G, KC>(acc, valid, lane, i, y, ys_c, ep);
}

// the operator of one launch: the padded form (rowptr null) or the
// row-pointer form with int32 (index64 = 0) or int64 pointers
struct Op {
  const void* rowptr;
  int index64;
  const void* vals;
  const int* cols;
  int64_t rows;
  int K;
};

template <typename T, typename V, int G, int KC>
cudaError_t launch_gk(cudaStream_t stream, const Op& op, const T* x, T* y,
                      int64_t ys_c, const Epilogue<T>& ep) {
  constexpr int RB = kThreads / G;
  const unsigned blocks = (unsigned)((op.rows + RB - 1) / RB);
  const V* v = (const V*)op.vals;
  if (op.rowptr == nullptr) {
    ell_spmv_kernel<T, V, G, KC><<<blocks, kThreads, 0, stream>>>(
        v, op.cols, x, y, op.rows, op.K, ys_c, ep);
  } else if (op.index64) {
    ell_rowptr_kernel<T, V, int64_t, G, KC><<<blocks, kThreads, 0, stream>>>(
        (const int64_t*)op.rowptr, v, op.cols, x, y, op.rows, ys_c, ep);
  } else {
    ell_rowptr_kernel<T, V, int32_t, G, KC><<<blocks, kThreads, 0, stream>>>(
        (const int32_t*)op.rowptr, v, op.cols, x, y, op.rows, ys_c, ep);
  }
  return cudaGetLastError();
}

template <typename T, typename V, int G>
cudaError_t launch_g(cudaStream_t stream, int ncols, const Op& op,
                     const T* x, T* y, int64_t ys_c,
                     const Epilogue<T>& ep) {
  switch (ncols) {
    case 1: return launch_gk<T, V, G, 1>(stream, op, x, y, ys_c, ep);
    case 2: return launch_gk<T, V, G, 2>(stream, op, x, y, ys_c, ep);
    case 3: return launch_gk<T, V, G, 3>(stream, op, x, y, ys_c, ep);
    case 4: return launch_gk<T, V, G, 4>(stream, op, x, y, ys_c, ep);
    case 5: return launch_gk<T, V, G, 5>(stream, op, x, y, ys_c, ep);
    case 6: return launch_gk<T, V, G, 6>(stream, op, x, y, ys_c, ep);
    case 7: return launch_gk<T, V, G, 7>(stream, op, x, y, ys_c, ep);
    case 8: return launch_gk<T, V, G, 8>(stream, op, x, y, ys_c, ep);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename V>
int launch(const Op& op, const void* x, void* y, int groups, int ncols,
           int64_t ys_c, const void* b, const void* s, const void* c,
           double w, void* stream) {
  if (op.rows <= 0 || op.rows > ((int64_t)1 << 40) ||
      (op.rowptr == nullptr && op.K <= 0) || ncols < 1 ||
      ncols > kMaxCols) {
    return (int)cudaErrorInvalidValue;
  }
  const Epilogue<T> ep{(const T*)b, (const T*)s, (const T*)c, (T)w};
  const cudaStream_t sm = (cudaStream_t)stream;
  const T* xx = (const T*)x;
  T* yy = (T*)y;
  switch (groups) {
    case 1: return (int)launch_g<T, V, 1>(sm, ncols, op, xx, yy, ys_c, ep);
    case 2: return (int)launch_g<T, V, 2>(sm, ncols, op, xx, yy, ys_c, ep);
    case 4: return (int)launch_g<T, V, 4>(sm, ncols, op, xx, yy, ys_c, ep);
    case 8: return (int)launch_g<T, V, 8>(sm, ncols, op, xx, yy, ys_c, ep);
    case 16:
      return (int)launch_g<T, V, 16>(sm, ncols, op, xx, yy, ys_c, ep);
    case 32:
      return (int)launch_g<T, V, 32>(sm, ncols, op, xx, yy, ys_c, ep);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int pack(const void* x, int64_t xs_c, int64_t n, int ncols, void* xp,
         void* stream) {
  if (n <= 0 || n > ((int64_t)1 << 40)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t sm = (cudaStream_t)stream;
  const T* xx = (const T*)x;
  T* pp = (T*)xp;
  switch (ncols) {
#define PACK(KC_)                                                           \
  case KC_:                                                                 \
    ell_pack_kernel<T, KC_><<<blocks, kThreads, 0, sm>>>(xx, xs_c, n, pp);  \
    break;
    PACK(2)
    PACK(3)
    PACK(4)
    PACK(5)
    PACK(6)
    PACK(7)
    PACK(8)
#undef PACK
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: rowptr null for the padded form (vals and cols (rows,
// K) row-major), else rows + 1 pointers of int32 (index64 = 0) or int64
// and vals and cols (nnz,), K unused; groups: G threads a row, one of 1, 2,
// 4, 8, 16, 32; ncols: the columns k (1 to 8); x one vector (k = 1) or k
// packed by ell_pack ((n, k)); y, b, c column j at j * ys_c; b,
// s, c: null or vectors of y's rows (s one for all columns); all null: y
// = A x, else y = c + w s (.) (b - A x); y may be c.  _f32 and _f64 take
// values of x's type, _bf16_f32 and _bf16_f64 bf16 values (their bits)
#define ELL_ENTRY(NAME, T, V)                                               \
  extern "C" int NAME(const void* rowptr, int index64, const void* vals,    \
                      const void* cols, const void* x, void* y,             \
                      int64_t rows, int K, int groups, int ncols,           \
                      int64_t ys_c, const void* b, const void* s,           \
                      const void* c, double w, void* stream) {              \
    const Op op{rowptr, index64, vals, (const int*)cols, rows, K};          \
    return launch<T, V>(op, x, y, groups, ncols, ys_c, b, s, c, w, stream); \
  }
