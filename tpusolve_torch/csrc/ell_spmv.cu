// Padded-ELL sparse matrix-vector product for Hopper (sm_90a): K2.
//
// Replaces tpusolve/matrix/spmv.py:74 ell_spmv_local (an XLA fusion in
// tpusolve, not a Pallas kernel), the compute half of _spmv_shard_ell
// (:223) and of _offd_add's ghost term (:133).  For every row i of a
// (rows, K) padded-ELL block, values and int32 columns both row-major:
//
//     (A x)[i] = sum_k vals[i, k] * x[cols[i, k]]
//
// A padded slot holds value 0 and column 0, a padded row only padded
// slots, so y is 0 there (as in the plain version, x[0] finite).  The
// block may be rectangular (the AMG transfers P and R): x has its own
// length, never read past the largest column.
//
// Two forms, one launch each, as K1 (csrc/dia_spmv.cu):
//   * y = A x;
//   * y = c + w * s (.) (b - A x), any of b, s, c absent (a null pointer:
//     b = 0, s = 1, c = 0), computed as the plain version computes it
//     (tpusolve_torch/kernels/dia.py: epilogue_plain): t = b - A x (or A x
//     without b), t = (w s) t, then c + t (c - t without b).  y may be c
//     (the AMG prolongation x + P e is written into x in place): the one
//     thread that writes y[i] reads c[i] first.  y must not be x, b or s.
//
// What bounds it: bytes.  One SpMV reads each slot's value and column
// once, x once (more where the gathers miss L2) and writes y once:
// (itemsize + 4) * rows * K + (cols + rows) * itemsize bytes, two flops a
// slot, far below the card's rate for the operations.  The design, simple
// first:
//   * G threads a row (G = 1 .. 32, a power of two chosen by the caller:
//     kernels/ell.py k2_plan): the G lanes of a row read consecutive slots
//     of the row-major arrays, so a warp's loads of values and columns
//     are contiguous runs of G entries (the whole warp one run when
//     G = 32);
//   * slots in stages of kStage a lane: a stage's values and columns are
//     loaded, then its x entries gathered through the read-only path
//     (__ldg), then multiplied and added, so each thread keeps kStage
//     gathers in flight;
//   * lane g sums slots g, g + G, g + 2G, ... in order with one fused
//     multiply-add each, then the G partial sums meet by a shuffle tree in
//     a fixed order (no atomics): the same bits in every run;
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
constexpr int kStage = 4;      // slots a lane loads before its adds

template <typename T>
struct Epilogue {
  const T* b;
  const T* s;
  const T* c;
  T w;
};

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                const T* __restrict__ x, T* y, int64_t rows, int K,
                const Epilogue<T> ep) {
  constexpr int RB = kThreads / G;  // rows a block
  const int lane = threadIdx.x % G;
  const int64_t i = (int64_t)blockIdx.x * RB + threadIdx.x / G;
  const bool valid = i < rows;
  const T* vr = vals + i * K;
  const int* cr = cols + i * K;

  T acc = T(0);
  if (valid) {
    for (int k0 = lane; k0 < K; k0 += G * kStage) {
      T v[kStage];
      int c[kStage];
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int k = k0 + s * G;
        v[s] = T(0);
        c[s] = 0;
        if (k < K) {
          v[s] = __ldg(vr + k);
          c[s] = __ldg(cr + k);
        }
      }
      T xv[kStage];
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        xv[s] = k0 + s * G < K ? __ldg(x + c[s]) : T(0);
      }
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        acc = fma(v[s], xv[s], acc);
      }
    }
  }
  // every lane of the warp takes part in the shuffles, rows past the end
  // too (their sums are zero and never written)
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
cudaError_t launch_g(cudaStream_t stream, const T* vals, const int* cols,
                     const T* x, T* y, int64_t rows, int K,
                     const Epilogue<T>& ep) {
  constexpr int RB = kThreads / G;
  const int64_t blocks = (rows + RB - 1) / RB;
  ell_spmv_kernel<T, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      vals, cols, x, y, rows, K, ep);
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

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
