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
//     without b), each step rounded on its own (no fused multiply-add).
//     y must not be x, b, s or c.
//
// The row sum and the epilogue live in csrc/box_cycle.cuh, which the fused
// cycle kernels of csrc/box_cycle.cu include too: they equal this kernel's
// residual and update forms bit for bit.
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
// The bfloat16 value form (the smoother twin, smoother_dtype: bfloat16):
// V = uint16_t holds each plane value's bf16 bits, widened exactly to x's
// type (f32 or f64) before its fused multiply-add, so that the launch
// equals the full-precision kernel on the values rounded to bf16 bit for
// bit while it reads half (f32) or a quarter (f64) of the plane bytes.
// Loaded one 16-bit value a thread, the planes took 0.148 ms on the 128^3
// level where the f32 form takes 0.086 (PERF.md): the loads, not the
// bytes, set the time.  So at one thread a row on a box of an even row
// count (warp_tile) a warp takes 64 rows, lane l rows l and l + 32: lane l
// loads the 32-bit word l of each plane's tile (rows 2l and 2l + 1), and
// two shuffles hand every lane its two values; each row still sums its
// slots in stored order, one fused multiply-add each (a slot whose
// neighbour is outside the box adds its finite value times 0, which leaves
// the sum's bits as the one-value form's 0 * 0 does).
// Staging the x window a block's rows reach in shared memory was measured
// slower at every G and box (PERF.md), and is not kept.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "box_cycle.cuh"

namespace {

using box_cycle::kMaxSlots;
using box_cycle::Plan;   // rows a block, and threads a block, at G a row
using box_cycle::Slots;

// the optional epilogue y = c + w * s (.) (b - A x), applied when any of
// b, s, c is given
template <typename T>
struct Epilogue {
  const T* b;
  const T* s;
  const T* c;
  T w;
};

// the warp-tile form of the bf16 planes at one thread a row: 64 rows a
// warp, lane l rows l and l + 32 of it, each plane's 64 values of the tile
// read as 32 words, one a lane, and shuffled to the lanes whose rows they
// hold.  The box's row count is even, so every word is 4-byte aligned and
// lies inside its plane.
template <typename T>
__device__ __forceinline__ void warp_tile(const uint16_t* __restrict__ vals,
                                          const T* __restrict__ x, T* y,
                                          const Slots& slots, int nslots,
                                          int nz, int ny, int nx,
                                          const Epilogue<T>& ep) {
  constexpr int kTileWarps = Plan<1>::kThreads / 32;
  const int64_t box = (int64_t)nz * ny * nx;
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.y;
  const int64_t t0 = ((int64_t)blockIdx.x * kTileWarps + threadIdx.x / 32)
                     * 64;
  int64_t i[2];
  bool valid[2];
  int iz[2], iy[2], ix[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    i[k] = t0 + lane + 32 * k;
    valid[k] = i[k] < box;
    ix[k] = iy[k] = iz[k] = 0;
    if (valid[k]) {
      ix[k] = (int)(i[k] % nx);
      const int64_t zy = i[k] / nx;
      iy[k] = (int)(zy % ny);
      iz[k] = (int)(zy / ny);
    }
  }
  // lane's word: rows t0 + 2 lane and t0 + 2 lane + 1 of slot 0's plane
  const int64_t e = t0 + 2 * lane;
  const uint32_t* vw = reinterpret_cast<const uint32_t*>(
      vals + (int64_t)p * nslots * box + e);
  const bool has_word = e < box;
  const T* xp = x + (int64_t)p * box;
  T acc[2] = {T(0), T(0)};
  for (int d0 = 0; d0 < nslots; d0 += box_cycle::kStage) {
    uint32_t w[box_cycle::kStage];
    T xv[2][box_cycle::kStage];
#pragma unroll
    for (int s = 0; s < box_cycle::kStage; ++s) {
      const int d = d0 + s;
      w[s] = 0u;
      if (has_word && d < nslots) {
        w[s] = __ldg(vw + (int64_t)d * (box / 2));
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        xv[k][s] = T(0);
        if (valid[k] && d < nslots) {
          const int z = iz[k] + slots.d[d][0];
          const int yy = iy[k] + slots.d[d][1];
          const int xx = ix[k] + slots.d[d][2];
          if ((unsigned)z < (unsigned)nz && (unsigned)yy < (unsigned)ny &&
              (unsigned)xx < (unsigned)nx) {
            xv[k][s] = __ldg(xp + i[k] + slots.d[d][3]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < box_cycle::kStage; ++s) {
      // row l's value is in lane l / 2's word, row l + 32's in lane
      // 16 + l / 2's; the low half holds the even row
      const uint32_t w0 = __shfl_sync(0xffffffffu, w[s], lane >> 1);
      const uint32_t w1 = __shfl_sync(0xffffffffu, w[s], 16 + (lane >> 1));
      const uint32_t h0 = (lane & 1) ? (w0 & 0xffff0000u) : (w0 << 16);
      const uint32_t h1 = (lane & 1) ? (w1 & 0xffff0000u) : (w1 << 16);
      // a neighbour outside the box has x = 0: v * 0 + acc is acc, since
      // acc starts at +0 and a round-to-nearest sum is never -0 unless
      // both terms are, so these are the one-value form's bits
      acc[0] = fma((T)__uint_as_float(h0), xv[0][s], acc[0]);
      acc[1] = fma((T)__uint_as_float(h1), xv[1][s], acc[1]);
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!valid[k]) {
      continue;
    }
    const int64_t o = (int64_t)p * box + i[k];
    T a = acc[k];
    if (ep.b != nullptr || ep.s != nullptr || ep.c != nullptr) {
      a = box_cycle::epilogue(
          a, ep.b != nullptr, ep.b != nullptr ? ep.b[o] : T(0),
          ep.s != nullptr, ep.s != nullptr ? ep.s[o] : T(0), ep.c != nullptr,
          ep.c != nullptr ? ep.c[o] : T(0), ep.w);
    }
    y[o] = a;
  }
}

// whether K1 runs the warp-tile form: bf16 planes, one thread a row, a box
// of an even row count
template <typename V, int G>
bool tiled(int64_t box) {
  return G == 1 && sizeof(V) == 2 && box % 2 == 0;
}

template <typename T, typename V, int G>
__global__ void __launch_bounds__(Plan<G>::kThreads)
dia_spmv_kernel(const V* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, const __grid_constant__ Slots slots,
                int nslots, int nz, int ny, int nx, const Epilogue<T> ep) {
  constexpr int RB = Plan<G>::RB;
  const int64_t box = (int64_t)nz * ny * nx;
  if constexpr (G == 1 && sizeof(V) == 2) {
    if (box % 2 == 0) {   // uniform over the launch (tiled)
      warp_tile<T>(vals, x, y, slots, nslots, nz, ny, nx, ep);
      return;
    }
  }
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
  const V* vp = vals + (int64_t)p * nslots * box + i;
  const int chunk = (nslots + G - 1) / G;
  const int d_lo = g * chunk;
  const int d_hi = min(nslots, d_lo + chunk);

  T acc = box_cycle::row_partial<T, V>(
      vp, box, slots, d_lo, d_hi, valid, iz, iy, ix, nz, ny, nx,
      [&](int d) { return __ldg(xw + slots.d[d][3]); });

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
    acc = box_cycle::epilogue(
        acc, ep.b != nullptr, ep.b != nullptr ? ep.b[o] : T(0),
        ep.s != nullptr, ep.s != nullptr ? ep.s[o] : T(0), ep.c != nullptr,
        ep.c != nullptr ? ep.c[o] : T(0), ep.w);
  }
  y[o] = acc;
}

template <typename T, typename V, int G>
cudaError_t launch_g(dim3 grid, cudaStream_t stream, const V* vals,
                     const T* x, T* y, const Slots& slots, int nslots,
                     int nz, int ny, int nx, const Epilogue<T>& ep) {
  dia_spmv_kernel<T, V, G><<<grid, Plan<G>::kThreads, 0, stream>>>(
      vals, x, y, slots, nslots, nz, ny, nx, ep);
  return cudaGetLastError();
}

template <typename T, typename V>
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
  const V* v = (const V*)vals;
  const T* xx = (const T*)x;
  T* yy = (T*)y;
  // one block per RB rows of a part
  auto grid = [&](int rb) {
    return dim3((unsigned)((box + rb - 1) / rb), nparts);
  };
  switch (groups) {
    case 1:   // the warp-tile form takes two rows a thread
      return (int)launch_g<T, V, 1>(
          grid(Plan<1>::RB * (tiled<V, 1>(box) ? 2 : 1)), st, v, xx, yy,
          slots, nslots, nz, ny, nx, ep);
    case 2:
      return (int)launch_g<T, V, 2>(grid(Plan<2>::RB), st, v, xx, yy, slots,
                                    nslots, nz, ny, nx, ep);
    case 4:
      return (int)launch_g<T, V, 4>(grid(Plan<4>::RB), st, v, xx, yy, slots,
                                    nslots, nz, ny, nx, ep);
    case 8:
      return (int)launch_g<T, V, 8>(grid(Plan<8>::RB), st, v, xx, yy, slots,
                                    nslots, nz, ny, nx, ep);
    case 16:
      return (int)launch_g<T, V, 16>(grid(Plan<16>::RB), st, v, xx, yy,
                                     slots, nslots, nz, ny, nx, ep);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// groups: G threads a row, one of 1, 2, 4, 8, 16; b, s, c: null or
// vectors of y's shape; all null: y = A x, else y = c + w s (.) (b - A x).
// _f32 and _f64 take planes of x's type, _bf16_f32 and _bf16_f64 bf16
// planes (their bits)
#define DIA_ENTRY(NAME, T, V)                                                \
  int NAME(const void* vals, const void* x, void* y, const int* offs,       \
           int nslots, int nparts, int nz, int ny, int nx, int groups,      \
           const void* b, const void* s, const void* c, double w,           \
           void* stream) {                                                  \
    return launch<T, V>(vals, x, y, offs, nslots, nparts, nz, ny, nx,       \
                        groups, b, s, c, w, stream);                        \
  }

DIA_ENTRY(dia_spmv_f32, float, float)
DIA_ENTRY(dia_spmv_f64, double, double)
DIA_ENTRY(dia_spmv_bf16_f32, float, uint16_t)
DIA_ENTRY(dia_spmv_bf16_f64, double, uint16_t)

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
