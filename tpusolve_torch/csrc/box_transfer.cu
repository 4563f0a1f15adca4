// Box transfers of the structured V-cycle for Hopper (sm_90a): K3.
//
// Replaces tpusolve/amg/structured.py:122 _prolong_local and :129
// _restrict_local (an XLA fusion in tpusolve, not a Pallas kernel): the
// cell-centred trilinear prolongation of one part's coarse box (nz, ny, nx)
// onto its fine box (2nz, 2ny, 2nx), x fastest, and its exact adjoint.
// Along one axis of coarse extent m, fine cell i takes coarse cell c = i/2
// and its neighbour on i's side, clamped at the box's edge:
//
//     fine 2c   = .75 a[c] + .25 a[max(c - 1, 0)]
//     fine 2c+1 = .75 a[c] + .25 a[min(c + 1, m - 1)]
//
// and the restriction is the transpose, coarse c = .75 (r[2c] + r[2c+1])
// + .25 r[2c-1] + .25 r[2c+2], where a missing r[-1] or r[2m] is replaced by
// the edge cell itself (weight 1.0 on r[0] and r[2m-1]).
//
// The plain versions (tpusolve_torch/kernels/transfer.py) apply the three
// axes one after the other, z, then y, then x, each step a rounded multiply
// or add.  Both kernels do the same arithmetic in the same order for each
// output point, with the round-to-nearest intrinsics (no contraction into
// fused multiply-adds), so they equal the plain versions bit for bit.
//
// What bounds them: bytes, and below that a launch's latency.  At gate 1's
// 64^3 -> 32^3 in f32 the prolongation moves 0.13 MB of coarse values and
// 2.1 MB of fine ones (the added x read, the result written), a few
// microseconds at the card's rate, about one launch.  So the design is one
// launch a transfer, all three axes in one pass, nothing staged:
//   * prolongation: one thread a fine point reads its 2 x 2 x 2 coarse
//     neighbours (L1 and L2 serve the eight-fold reuse of each coarse value)
//     and, as its epilogue, adds the fine vector x:  out = x + P xc.  `out`
//     may be `x` itself, updated in place (each thread reads and writes only
//     its own point); tpusolve's version is pure and returns a new array;
//   * restriction: one thread a coarse point reads its 4 x 4 x 4 fine
//     neighbours and sums them in the plain version's fixed order: no
//     atomics, the same bits in every run.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// .75 a + .25 b, the plain version's step of the prolongation
template <typename T>
__device__ __forceinline__ T up(T a, T b) {
  return add_rn(mul_rn(T(0.75), a), mul_rn(T(0.25), b));
}

// .75 (e + o) + .25 lo + .25 hi, the plain version's step of the restriction
template <typename T>
__device__ __forceinline__ T down(T e, T o, T lo, T hi) {
  return add_rn(add_rn(mul_rn(T(0.75), add_rn(e, o)), mul_rn(T(0.25), lo)),
                mul_rn(T(0.25), hi));
}

// out = (x +) P xc over each part's fine box; x may be null, out may be x
template <typename T>
__global__ void __launch_bounds__(kThreads)
box_prolong_kernel(const T* __restrict__ xc, const T* x, T* out, int nz,
                   int ny, int nx) {
  const int fy = 2 * ny, fx = 2 * nx;
  const int64_t fine = (int64_t)2 * nz * fy * fx;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= fine) {
    return;
  }
  const int p = blockIdx.y;
  const int ix = (int)(i % fx);
  const int64_t zy = i / fx;
  const int iy = (int)(zy % fy);
  const int iz = (int)(zy / fy);
  // each axis: the coarse cell and its clamped neighbour on i's side
  const int cz = iz >> 1, cy = iy >> 1, cx = ix >> 1;
  const int nbz = (iz & 1) ? min(cz + 1, nz - 1) : max(cz - 1, 0);
  const int nby = (iy & 1) ? min(cy + 1, ny - 1) : max(cy - 1, 0);
  const int nbx = (ix & 1) ? min(cx + 1, nx - 1) : max(cx - 1, 0);
  const T* a = xc + (int64_t)p * nz * ny * nx;
  const int ys[2] = {cy, nby};
  const int xs[2] = {cx, nbx};
  T v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    T u[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t yx = (int64_t)ys[j] * nx + xs[k];
      u[j] = up(__ldg(a + (int64_t)cz * ny * nx + yx),
                __ldg(a + (int64_t)nbz * ny * nx + yx));   // along z
    }
    v[k] = up(u[0], u[1]);                                 // along y
  }
  T w = up(v[0], v[1]);                                    // along x
  const int64_t o = (int64_t)p * fine + i;
  if (x != nullptr) {
    w = add_rn(x[o], w);
  }
  out[o] = w;
}

// out = P^T rf over each part's coarse box (nz, ny, nx)
template <typename T>
__global__ void __launch_bounds__(kThreads)
box_restrict_kernel(const T* __restrict__ rf, T* __restrict__ out, int nz,
                    int ny, int nx) {
  const int64_t coarse = (int64_t)nz * ny * nx;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= coarse) {
    return;
  }
  const int p = blockIdx.y;
  const int cx = (int)(i % nx);
  const int64_t zy = i / nx;
  const int cy = (int)(zy % ny);
  const int cz = (int)(zy / ny);
  const int fy = 2 * ny, fx = 2 * nx;
  // each axis: the fine cells 2c, 2c+1, and 2c-1 and 2c+2 with the edge
  // cell standing in for a missing one
  const int zs[4] = {2 * cz, 2 * cz + 1, cz > 0 ? 2 * cz - 1 : 2 * cz,
                     cz < nz - 1 ? 2 * cz + 2 : 2 * cz + 1};
  const int ys[4] = {2 * cy, 2 * cy + 1, cy > 0 ? 2 * cy - 1 : 2 * cy,
                     cy < ny - 1 ? 2 * cy + 2 : 2 * cy + 1};
  const int xs[4] = {2 * cx, 2 * cx + 1, cx > 0 ? 2 * cx - 1 : 2 * cx,
                     cx < nx - 1 ? 2 * cx + 2 : 2 * cx + 1};
  const T* r = rf + (int64_t)p * 8 * coarse;
  T v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t yx = (int64_t)ys[j] * fx + xs[k];
      T t[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        t[m] = __ldg(r + (int64_t)zs[m] * fy * fx + yx);
      }
      u[j] = down(t[0], t[1], t[2], t[3]);                 // along z
    }
    v[k] = down(u[0], u[1], u[2], u[3]);                   // along y
  }
  out[(int64_t)p * coarse + i] = down(v[0], v[1], v[2], v[3]);  // along x
}

bool bad_box(int nparts, int nz, int ny, int nx) {
  return nparts <= 0 || nz <= 0 || ny <= 0 || nx <= 0 ||
         (int64_t)8 * nz * ny * nx >= ((int64_t)1 << 31);
}

template <typename T>
int prolong(const void* xc, const void* x, void* out, int nparts, int nz,
            int ny, int nx, void* stream) {
  if (bad_box(nparts, nz, ny, nx)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t fine = (int64_t)8 * nz * ny * nx;
  const dim3 grid((unsigned)((fine + kThreads - 1) / kThreads), nparts);
  box_prolong_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)xc, (const T*)x, (T*)out, nz, ny, nx);
  return (int)cudaGetLastError();
}

template <typename T>
int restrict_(const void* rf, void* out, int nparts, int nz, int ny, int nx,
              void* stream) {
  if (bad_box(nparts, nz, ny, nx)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t coarse = (int64_t)nz * ny * nx;
  const dim3 grid((unsigned)((coarse + kThreads - 1) / kThreads), nparts);
  box_restrict_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)rf, (T*)out, nz, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (nz, ny, nx) is the coarse box in every entry point
int box_prolong_f32(const void* xc, const void* x, void* out, int nparts,
                    int nz, int ny, int nx, void* stream) {
  return prolong<float>(xc, x, out, nparts, nz, ny, nx, stream);
}

int box_prolong_f64(const void* xc, const void* x, void* out, int nparts,
                    int nz, int ny, int nx, void* stream) {
  return prolong<double>(xc, x, out, nparts, nz, ny, nx, stream);
}

int box_restrict_f32(const void* rf, void* out, int nparts, int nz, int ny,
                     int nx, void* stream) {
  return restrict_<float>(rf, out, nparts, nz, ny, nx, stream);
}

int box_restrict_f64(const void* rf, void* out, int nparts, int nz, int ny,
                     int nx, void* stream) {
  return restrict_<double>(rf, out, nparts, nz, ny, nx, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
