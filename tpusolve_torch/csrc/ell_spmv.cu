// ELL sparse matrix-vector product for Hopper (sm_90a): K2, in two forms.
//
// Replaces tpusolve/matrix/spmv.py:74 ell_spmv_local (an XLA fusion in
// tpusolve, not a Pallas kernel), the compute half of _spmv_shard_ell
// (:223) and of _offd_add's ghost term (:133).  For every row i
//
//     (A x)[i] = sum_k vals[i, k] * x[cols[i, k]]
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
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kStage = 4;      // entries a lane loads before its adds

template <typename T>
struct Epilogue {
  const T* b;
  const T* s;
  const T* c;
  T w;
};

// lane's partial sum of the entries [beg + lane, end) step G of a row whose
// values and columns are v[k], c[k], read through the read-only path
template <typename T, int G>
__device__ __forceinline__ T row_sum(const T* __restrict__ v,
                                     const int* __restrict__ c, int64_t beg,
                                     int64_t end, int lane,
                                     const T* __restrict__ x) {
  T acc = T(0);
  for (int64_t k0 = beg + lane; k0 < end; k0 += G * kStage) {
    T vv[kStage];
    int cc[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int64_t k = k0 + s * G;
      vv[s] = T(0);
      cc[s] = 0;
      if (k < end) {
        vv[s] = __ldg(v + k);
        cc[s] = __ldg(c + k);
      }
    }
    T xv[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      xv[s] = k0 + s * G < end ? __ldg(x + cc[s]) : T(0);
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      acc = fma(vv[s], xv[s], acc);
    }
  }
  return acc;
}

// the G partial sums of a row meet in lane 0, which applies the epilogue
// and writes y[i]; every lane of the warp takes part in the shuffles, rows
// past the end too (their sums are zero and never written)
template <typename T, int G>
__device__ __forceinline__ void finish_row(T acc, bool valid, int lane,
                                           int64_t i, T* y,
                                           const Epilogue<T>& ep) {
  if constexpr (G > 1) {
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) {
      acc += __shfl_down_sync(0xffffffffu, acc, off, G);
    }
  }
  if (!valid || lane != 0) {
    return;
  }
  if (ep.b != nullptr || ep.s != nullptr || ep.c != nullptr) {
    T t = ep.b != nullptr ? ep.b[i] - acc : acc;
    t = ep.s != nullptr ? (ep.w * ep.s[i]) * t : ep.w * t;
    if (ep.c != nullptr) {
      t = ep.b != nullptr ? ep.c[i] + t : ep.c[i] - t;
    } else if (ep.b == nullptr) {
      t = -t;
    }
    acc = t;
  }
  y[i] = acc;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                const T* __restrict__ x, T* y, int64_t rows, int K,
                const Epilogue<T> ep) {
  constexpr int RB = kThreads / G;  // rows a block
  const int lane = threadIdx.x % G;
  const int64_t i = (int64_t)blockIdx.x * RB + threadIdx.x / G;
  const bool valid = i < rows;
  T acc = T(0);
  if (valid) {
    acc = row_sum<T, G>(vals + i * K, cols + i * K, 0, K, lane, x);
  }
  finish_row<T, G>(acc, valid, lane, i, y, ep);
}

template <typename T, typename I, int G>
__global__ void __launch_bounds__(kThreads)
ell_rowptr_kernel(const I* __restrict__ rowptr, const T* __restrict__ vals,
                  const int* __restrict__ cols, const T* __restrict__ x,
                  T* y, int64_t rows, const Epilogue<T> ep) {
  constexpr int RB = kThreads / G;  // rows a block
  const int lane = threadIdx.x % G;
  const int64_t i = (int64_t)blockIdx.x * RB + threadIdx.x / G;
  const bool valid = i < rows;
  T acc = T(0);
  if (valid) {
    acc = row_sum<T, G>(vals, cols, (int64_t)__ldg(rowptr + i),
                        (int64_t)__ldg(rowptr + i + 1), lane, x);
  }
  finish_row<T, G>(acc, valid, lane, i, y, ep);
}

template <typename T, int G>
cudaError_t launch_g(cudaStream_t stream, const T* vals, const int* cols,
                     const T* x, T* y, int64_t rows, int K,
                     const Epilogue<T>& ep) {
  constexpr int RB = kThreads / G;
  const int64_t blocks = (rows + RB - 1) / RB;
  ell_spmv_kernel<T, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      vals, cols, x, y, rows, K, ep);
  return cudaGetLastError();
}

template <typename T, typename I, int G>
cudaError_t launch_rowptr_g(cudaStream_t stream, const I* rowptr,
                            const T* vals, const int* cols, const T* x, T* y,
                            int64_t rows, const Epilogue<T>& ep) {
  constexpr int RB = kThreads / G;
  const int64_t blocks = (rows + RB - 1) / RB;
  ell_rowptr_kernel<T, I, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      rowptr, vals, cols, x, y, rows, ep);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* cols, const void* x, void* y,
           int64_t rows, int K, int groups, const void* b, const void* s,
           const void* c, double w, void* stream) {
  if (rows <= 0 || K <= 0 || rows > ((int64_t)1 << 40)) {
    return (int)cudaErrorInvalidValue;
  }
  const Epilogue<T> ep{(const T*)b, (const T*)s, (const T*)c, (T)w};
  const cudaStream_t st = (cudaStream_t)stream;
  const T* v = (const T*)vals;
  const int* cc = (const int*)cols;
  const T* xx = (const T*)x;
  T* yy = (T*)y;
  switch (groups) {
    case 1:
      return (int)launch_g<T, 1>(st, v, cc, xx, yy, rows, K, ep);
    case 2:
      return (int)launch_g<T, 2>(st, v, cc, xx, yy, rows, K, ep);
    case 4:
      return (int)launch_g<T, 4>(st, v, cc, xx, yy, rows, K, ep);
    case 8:
      return (int)launch_g<T, 8>(st, v, cc, xx, yy, rows, K, ep);
    case 16:
      return (int)launch_g<T, 16>(st, v, cc, xx, yy, rows, K, ep);
    case 32:
      return (int)launch_g<T, 32>(st, v, cc, xx, yy, rows, K, ep);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename I>
int launch_rowptr_s(const I* rp, const T* v, const int* cc, const T* xx,
                    T* yy, int64_t rows, int groups, const Epilogue<T>& ep,
                    cudaStream_t st) {
  switch (groups) {
    case 1:
      return (int)launch_rowptr_g<T, I, 1>(st, rp, v, cc, xx, yy, rows, ep);
    case 2:
      return (int)launch_rowptr_g<T, I, 2>(st, rp, v, cc, xx, yy, rows, ep);
    case 4:
      return (int)launch_rowptr_g<T, I, 4>(st, rp, v, cc, xx, yy, rows, ep);
    case 8:
      return (int)launch_rowptr_g<T, I, 8>(st, rp, v, cc, xx, yy, rows, ep);
    case 16:
      return (int)launch_rowptr_g<T, I, 16>(st, rp, v, cc, xx, yy, rows, ep);
    case 32:
      return (int)launch_rowptr_g<T, I, 32>(st, rp, v, cc, xx, yy, rows, ep);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_rowptr(const void* rowptr, int index64, const void* vals,
                  const void* cols, const void* x, void* y, int64_t rows,
                  int groups, const void* b, const void* s,
                  const void* c, double w, void* stream) {
  if (rows <= 0 || rows > ((int64_t)1 << 40)) {
    return (int)cudaErrorInvalidValue;
  }
  const Epilogue<T> ep{(const T*)b, (const T*)s, (const T*)c, (T)w};
  const cudaStream_t st = (cudaStream_t)stream;
  const T* v = (const T*)vals;
  const int* cc = (const int*)cols;
  const T* xx = (const T*)x;
  T* yy = (T*)y;
  if (index64) {
    return launch_rowptr_s<T, int64_t>((const int64_t*)rowptr, v, cc, xx, yy,
                                       rows, groups, ep, st);
  }
  return launch_rowptr_s<T, int32_t>((const int32_t*)rowptr, v, cc, xx, yy,
                                     rows, groups, ep, st);
}

}  // namespace

extern "C" {

// vals (rows, K) and cols (rows, K) row-major; groups: G threads a row,
// one of 1, 2, 4, 8, 16, 32; b, s, c: null or vectors of y's length; all
// null: y = A x, else y = c + w s (.) (b - A x); y may be c
int ell_spmv_f32(const void* vals, const void* cols, const void* x, void* y,
                 int64_t rows, int K, int groups, const void* b,
                 const void* s, const void* c, double w, void* stream) {
  return launch<float>(vals, cols, x, y, rows, K, groups, b, s, c, w,
                       stream);
}

int ell_spmv_f64(const void* vals, const void* cols, const void* x, void* y,
                 int64_t rows, int K, int groups, const void* b,
                 const void* s, const void* c, double w, void* stream) {
  return launch<double>(vals, cols, x, y, rows, K, groups, b, s, c, w,
                        stream);
}

// the row-pointer form: rowptr (rows + 1) of int32 (index64 = 0) or int64,
// vals and cols (nnz,); the rest as above
int ell_rowptr_spmv_f32(const void* rowptr, int index64, const void* vals,
                        const void* cols, const void* x, void* y,
                        int64_t rows, int groups, const void* b,
                        const void* s, const void* c, double w,
                        void* stream) {
  return launch_rowptr<float>(rowptr, index64, vals, cols, x, y, rows,
                              groups, b, s, c, w, stream);
}

int ell_rowptr_spmv_f64(const void* rowptr, int index64, const void* vals,
                        const void* cols, const void* x, void* y,
                        int64_t rows, int groups, const void* b,
                        const void* s, const void* c, double w,
                        void* stream) {
  return launch_rowptr<double>(rowptr, index64, vals, cols, x, y, rows,
                               groups, b, s, c, w, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
