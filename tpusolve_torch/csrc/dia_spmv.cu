// Box-DIA sparse matrix-vector product for Hopper (sm_90a): K1.
//
// Replaces tpusolve/matrix/spmv.py:79 dia_spmv_local, its rank-3 dia_shape
// branch (an XLA fusion in tpusolve, not a Pallas kernel).  For every part p
// and every row i = (z, y, x) of the part's (nz, ny, nx) box, x fastest:
//
//     y[p, i] = sum_d vals[p, d, z, y, x] * x[p, z + dz_d, y + dy_d, x + dx_d]
//
// over the D slots in their stored order, with a neighbour outside the box
// read as zero (tpusolve zero-pads the box and slices it).  Each slot's
// (dz, dy, dx) comes from the caller as a triple: the flat offset
// (dz*ny + dy)*nx + dx cannot be turned back into its triple when a
// component's magnitude reaches half the box's extent (a 4-wide coarse box
// under a 125-point Galerkin operator), so none is decomposed here.
//
// What bounds it: bytes.  One SpMV reads each plane's in-box slots once
// (a slot whose neighbour lies outside the box is never read), x once and
// writes y once: at most (D + 2) * R * itemsize bytes for R rows, two flops
// a slot and row, far below the card's rate for the operations.  The design:
//   * one thread a row, consecutive threads on consecutive x, so each
//     plane's loads and each shifted x window's loads are coalesced; the x
//     windows of the D slots overlap, and L1 and L2 serve all but about
//     one read of each x entry;
//   * the triples (and their flat offsets) in a table passed by value as a
//     kernel argument, read uniformly by every thread of a warp;
//   * a bounds test on each of dz, dy, dx; an out-of-box slot loads
//     nothing and adds zero;
//   * slots in stored order in stages of kStage: a stage's values and x
//     entries are all loaded before its multiply-adds, so each thread keeps
//     2 * kStage loads in flight; one fused multiply-add a slot, accumulated
//     in the value type (the plain version's order, not its bits: it rounds
//     the product and the sum apart).
// An x tile with its halo in shared memory, and the residual and Jacobi
// epilogues fused into the kernel, are later work (ROADMAP Queue 2).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 128;  // slots a table holds (kernels/dia.py)
constexpr int kThreads = 256;   // threads a block
constexpr int kStage = 8;       // slots whose loads are issued together

// (dz, dy, dx, flat offset) of each slot, in stored order
struct Slots {
  int d[kMaxSlots][4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, const Slots slots, int nslots, int nz,
                int ny, int nx) {
  const int64_t box = (int64_t)nz * ny * nx;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= box) {
    return;
  }
  const int p = blockIdx.y;
  const int ix = (int)(i % nx);
  const int64_t zy = i / nx;
  const int iy = (int)(zy % ny);
  const int iz = (int)(zy / ny);
  const T* xp = x + (int64_t)p * box + i;
  const T* vp = vals + (int64_t)p * nslots * box + i;

  T acc = T(0);
  for (int d0 = 0; d0 < nslots; d0 += kStage) {
    T v[kStage];
    T xv[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int d = d0 + s;
      v[s] = T(0);
      xv[s] = T(0);
      if (d < nslots) {
        const int z = iz + slots.d[d][0];
        const int yy = iy + slots.d[d][1];
        const int xx = ix + slots.d[d][2];
        if ((unsigned)z < (unsigned)nz && (unsigned)yy < (unsigned)ny &&
            (unsigned)xx < (unsigned)nx) {
          v[s] = __ldg(vp + (int64_t)d * box);
          xv[s] = __ldg(xp + slots.d[d][3]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      acc = fma(v[s], xv[s], acc);
    }
  }
  y[(int64_t)p * box + i] = acc;
}

template <typename T>
int launch(const void* vals, const void* x, void* y, const int* offs,
           int nslots, int nparts, int nz, int ny, int nx, void* stream) {
  if (nslots < 0 || nslots > kMaxSlots || nparts <= 0 || nz <= 0 ||
      ny <= 0 || nx <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Slots slots;
  for (int d = 0; d < nslots; ++d) {
    const int dz = offs[3 * d], dy = offs[3 * d + 1], dx = offs[3 * d + 2];
    slots.d[d][0] = dz;
    slots.d[d][1] = dy;
    slots.d[d][2] = dx;
    slots.d[d][3] = (dz * ny + dy) * nx + dx;
  }
  const int64_t box = (int64_t)nz * ny * nx;
  const dim3 grid((unsigned)((box + kThreads - 1) / kThreads), nparts);
  dia_spmv_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)vals, (const T*)x, (T*)y, slots, nslots, nz, ny, nx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dia_spmv_f32(const void* vals, const void* x, void* y, const int* offs,
                 int nslots, int nparts, int nz, int ny, int nx,
                 void* stream) {
  return launch<float>(vals, x, y, offs, nslots, nparts, nz, ny, nx, stream);
}

int dia_spmv_f64(const void* vals, const void* x, void* y, const int* offs,
                 int nslots, int nparts, int nz, int ny, int nx,
                 void* stream) {
  return launch<double>(vals, x, y, offs, nslots, nparts, nz, ny, nx, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
