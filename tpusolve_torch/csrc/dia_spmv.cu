// Box-DIA sparse matrix-vector product for Hopper (sm_90a): K1.
//
// Replaces tpusolve/matrix/spmv.py:79 dia_spmv_local, its rank-3 dia_shape
// branch (an XLA fusion in tpusolve, not a Pallas kernel).  For every part p
// and every row i = (z, y, x) of the part's (nz, ny, nx) box, x fastest:
//
//     (A x)[p, i] = sum_d vals[p, d, z, y, x] * x[p, z + dz_d, y + dy_d, x + dx_d]
//
// over the D slots in their stored order, with a neighbour outside the box
// read as zero (tpusolve zero-pads the box and slices it).  Each slot's
// (dz, dy, dx) comes from the caller as a triple: the flat offset
// (dz*ny + dy)*nx + dx cannot be turned back into its triple when a
// component's magnitude reaches half the box's extent (a 4-wide coarse box
// under a 125-point Galerkin operator), so none is decomposed here.
//
// Two forms, one launch each:
//   * y = A x;
//   * y = c + w * s (.) (b - A x), where any of b, s, c may be absent (a
//     null pointer: b = 0, s = 1, c = 0), taken whenever one of them is
//     given.  That one epilogue covers every update of the structured
//     V-cycle around an SpMV: the residual b - A x,
//     the Jacobi sweep x + w dinv (.) (b - A x), and Chebyshev's
//     dinv (.) (b - A x) and r - dinv (.) A d.  It is computed as the plain
//     version computes it (tpusolve_torch/kernels/dia.py: epilogue_plain):
//     t = b - A x (or A x without b), t = (w s) t, then c + t (c - t
//     without b).  y must not be x, b, s or c.
//
// What bounds it: bytes on the large boxes, a launch's latency on the small
// ones.  One SpMV reads each plane's in-box slots once (a slot whose
// neighbour lies outside the box is never read), x once and writes y once:
// at most (D + 2) * R * itemsize bytes for R rows, plus b, s and c, two
// flops a slot and row, far below the card's rate for the operations.
// The design:
//   * consecutive threads on consecutive rows, so each plane's loads and
//     each shifted x window's loads are coalesced; the x windows of the D
//     slots overlap, and L1 and L2 serve all but about one read of each x
//     entry;
//   * the triples (and their flat offsets) in a table passed by value as a
//     kernel argument, read uniformly by every thread of a warp;
//   * a bounds test on each of dz, dy, dx; an out-of-box slot loads
//     nothing and adds zero;
//   * slots in stages of kStage: a stage's values and x entries are all
//     loaded before its multiply-adds, so each thread keeps 2 * kStage loads
//     in flight; one fused multiply-add a slot, accumulated in the value
//     type (the plain version's slot order, not its bits: it rounds the
//     product and the sum apart);
//   * on a box too small to fill the card, or with many slots a row, G
//     threads a row (G = 2 .. 16, chosen by the caller: kernels/dia.py
//     k1_plan, measured in PERF.md).  A box of 512 or 4,096 rows under
//     D = 125 gives one thread a row 16 stages of dependent loads on 2 or 16
//     blocks: a latency floor of about 15 us.  With G threads a row, group
//     g of a block walks the g-th contiguous chunk of ceil(D / G) slots for
//     the block's RB rows (rows fastest across the lanes, so loads stay
//     coalesced); the G partial sums meet in shared memory and the group-0
//     thread of each row adds them in group order and applies the epilogue
//     once.  The order is fixed: the same bits in every run, and for G = 1
//     the one-thread-a-row sum of earlier builds.
// Staging the x window a block's rows reach in shared memory was measured
// slower at every G and box (PERF.md), and is not kept.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 128;  // slots a table holds (kernels/dia.py)
constexpr int kStage = 8;       // slots whose loads are issued together

// rows a block, and threads a block, at G threads a row
template <int G>
struct Plan {
  static constexpr int RB = G == 1 ? 256 : (G <= 8 ? 256 / G : 32);
  static constexpr int kThreads = RB * G;
};

// (dz, dy, dx, flat offset) of each slot, in stored order
struct Slots {
  int d[kMaxSlots][4];
};

// the optional epilogue y = c + w * s (.) (b - A x), applied when any of
// b, s, c is given
template <typename T>
struct Epilogue {
  const T* b;
  const T* s;
  const T* c;
  T w;
};

template <typename T, int G>
__global__ void __launch_bounds__(Plan<G>::kThreads)
dia_spmv_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, const Slots slots, int nslots, int nz,
                int ny, int nx, const Epilogue<T> ep) {
  constexpr int RB = Plan<G>::RB;
  const int64_t box = (int64_t)nz * ny * nx;
  const int r = threadIdx.x % RB;
  const int g = threadIdx.x / RB;
  const int64_t row0 = (int64_t)blockIdx.x * RB;
  const int64_t i = row0 + r;
  const int p = blockIdx.y;
  const bool valid = i < box;
  int ix = 0, iy = 0, iz = 0;
  if (valid) {
    ix = (int)(i % nx);
    const int64_t zy = i / nx;
    iy = (int)(zy % ny);
    iz = (int)(zy / ny);
  }
  const T* xw = x + (int64_t)p * box + i;  // where slot offsets are added
  const T* vp = vals + (int64_t)p * nslots * box + i;
  const int chunk = (nslots + G - 1) / G;
  const int d_lo = g * chunk;
  const int d_hi = min(nslots, d_lo + chunk);

  T acc = T(0);
  for (int d0 = d_lo; d0 < d_hi; d0 += kStage) {
    T v[kStage];
    T xv[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int d = d0 + s;
      v[s] = T(0);
      xv[s] = T(0);
      if (valid && d < d_hi) {
        const int z = iz + slots.d[d][0];
        const int yy = iy + slots.d[d][1];
        const int xx = ix + slots.d[d][2];
        if ((unsigned)z < (unsigned)nz && (unsigned)yy < (unsigned)ny &&
            (unsigned)xx < (unsigned)nx) {
          v[s] = __ldg(vp + (int64_t)d * box);
          xv[s] = __ldg(xw + slots.d[d][3]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      acc = fma(v[s], xv[s], acc);
    }
  }

  if constexpr (G > 1) {
    __shared__ T part[G][RB];
    part[g][r] = acc;
    __syncthreads();
    if (g != 0) {
      return;
    }
#pragma unroll
    for (int k = 1; k < G; ++k) {
      acc += part[k][r];
    }
  }
  if (!valid) {
    return;
  }
  const int64_t o = (int64_t)p * box + i;
  if (ep.b != nullptr || ep.s != nullptr || ep.c != nullptr) {
    T t = ep.b != nullptr ? ep.b[o] - acc : acc;
    t = ep.s != nullptr ? (ep.w * ep.s[o]) * t : ep.w * t;
    if (ep.c != nullptr) {
      t = ep.b != nullptr ? ep.c[o] + t : ep.c[o] - t;
    } else if (ep.b == nullptr) {
      t = -t;
    }
    acc = t;
  }
  y[o] = acc;
}

template <typename T, int G>
cudaError_t launch_g(dim3 grid, cudaStream_t stream, const T* vals,
                     const T* x, T* y, const Slots& slots, int nslots,
                     int nz, int ny, int nx, const Epilogue<T>& ep) {
  dia_spmv_kernel<T, G><<<grid, Plan<G>::kThreads, 0, stream>>>(
      vals, x, y, slots, nslots, nz, ny, nx, ep);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* x, void* y, const int* offs,
           int nslots, int nparts, int nz, int ny, int nx, int groups,
           const void* b, const void* s, const void* c, double w,
           void* stream) {
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
  const Epilogue<T> ep{(const T*)b, (const T*)s, (const T*)c, (T)w};
  const cudaStream_t st = (cudaStream_t)stream;
  const T* v = (const T*)vals;
  const T* xx = (const T*)x;
  T* yy = (T*)y;
  // one block per RB rows of a part
  auto grid = [&](int rb) {
    return dim3((unsigned)((box + rb - 1) / rb), nparts);
  };
  switch (groups) {
    case 1:
      return (int)launch_g<T, 1>(grid(Plan<1>::RB), st, v, xx, yy, slots,
                                 nslots, nz, ny, nx, ep);
    case 2:
      return (int)launch_g<T, 2>(grid(Plan<2>::RB), st, v, xx, yy, slots,
                                 nslots, nz, ny, nx, ep);
    case 4:
      return (int)launch_g<T, 4>(grid(Plan<4>::RB), st, v, xx, yy, slots,
                                 nslots, nz, ny, nx, ep);
    case 8:
      return (int)launch_g<T, 8>(grid(Plan<8>::RB), st, v, xx, yy, slots,
                                 nslots, nz, ny, nx, ep);
    case 16:
      return (int)launch_g<T, 16>(grid(Plan<16>::RB), st, v, xx, yy, slots,
                                  nslots, nz, ny, nx, ep);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// groups: G threads a row, one of 1, 2, 4, 8, 16; b, s, c: null or
// vectors of y's shape; all null: y = A x, else y = c + w s (.) (b - A x)
int dia_spmv_f32(const void* vals, const void* x, void* y, const int* offs,
                 int nslots, int nparts, int nz, int ny, int nx, int groups,
                 const void* b, const void* s, const void* c, double w,
                 void* stream) {
  return launch<float>(vals, x, y, offs, nslots, nparts, nz, ny, nx, groups,
                       b, s, c, w, stream);
}

int dia_spmv_f64(const void* vals, const void* x, void* y, const int* offs,
                 int nslots, int nparts, int nz, int ny, int nx, int groups,
                 const void* b, const void* s, const void* c, double w,
                 void* stream) {
  return launch<double>(vals, x, y, offs, nslots, nparts, nz, ny, nx,
                        groups, b, s, c, w, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
