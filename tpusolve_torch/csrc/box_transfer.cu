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
// The steps live in csrc/box_cycle.cuh.  On the V-cycle the fused kernels
// of csrc/box_cycle.cu carry both transfers inside K1's launches, and
// these two kernels are the yardstick the fused ones must equal.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "box_cycle.cuh"

namespace {

using box_cycle::add_rn;

constexpr int kThreads = 256;  // threads a block

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
  const T* a = xc + (int64_t)p * nz * ny * nx;
  T w = box_cycle::prolong_point<T>(
      [&](int z, int y, int xx) {
        return __ldg(a + ((int64_t)z * ny + y) * nx + xx);
      },
      iz, iy, ix, nz, ny, nx);
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
  int zs[4], ys[4], xs[4];
  box_cycle::window(cz, nz, zs);
  box_cycle::window(cy, ny, ys);
  box_cycle::window(cx, nx, xs);
  const T* r = rf + (int64_t)p * 8 * coarse;
  out[(int64_t)p * coarse + i] = box_cycle::restrict_point<T>(
      [&](int m, int j, int k) {
        return __ldg(r + ((int64_t)zs[m] * fy + ys[j]) * fx + xs[k]);
      });
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
