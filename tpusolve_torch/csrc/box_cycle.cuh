// Arithmetic shared by the structured V-cycle's kernels: K1's row sum and
// update epilogue (csrc/dia_spmv.cu), K3's prolongation and restriction
// steps (csrc/box_transfer.cu), and the kernels that fuse them
// (csrc/box_cycle.cu).  Each source includes this one header, so a fused
// kernel does each operation of the pair it replaces in the same order with
// the same roundings, and its result equals the pair's bit for bit:
//   * the row sum is one fused multiply-add a slot, in stored slot order,
//     over a contiguous chunk of ceil(D / G) slots (K1's G threads a row);
//     the chunks' partial sums are added in chunk order by the caller;
//   * the update epilogue and K3's steps are built from the round-to-nearest
//     intrinsics, which the compiler never contracts into fused
//     multiply-adds, so no inlining context can change their bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace box_cycle {

constexpr int kMaxSlots = 128;  // slots a table holds (kernels/dia.py)
constexpr int kStage = 8;       // slots whose loads are issued together

// K1's block at G threads a row: RB rows, RB * G threads
template <int G>
struct Plan {
  static constexpr int RB = G == 1 ? 256 : (G <= 8 ? 256 / G : 32);
  static constexpr int kThreads = RB * G;
};

// (dz, dy, dx, flat offset) of each slot, in stored order
struct Slots {
  int d[kMaxSlots][4];
};

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
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// a plane value of type V as T, through the read-only path or, with
// `stream`, as streamed data: V is T, or uint16_t holding a bfloat16's bits
// (the smoother twin), widened exactly, so that the sums that follow are
// those of the values rounded to bf16 in T, as JAX promotes bf16 * f32
template <typename T, typename V>
__device__ __forceinline__ T load_plane(const V* p, bool stream) {
  if constexpr (std::is_same<V, uint16_t>::value) {
    const uint16_t u = stream ? __ldcs(p) : __ldg(p);
    return (T)__uint_as_float((uint32_t)u << 16);
  } else {
    return stream ? __ldcs(p) : __ldg(p);
  }
}

// K1's partial row sums of R rows over slots [d_lo, d_hi), in stored slot
// order, one fused multiply-add a slot, the R rows' loads of each stage of
// kStage slots issued together (R times the loads in flight of one row):
// acc[k] for row (iz[k], iy[k], ix[k]) of an (nz, ny, nx) box, vp[k] its
// value in slot 0's plane (planes `box` apart), xat(k, d) loads its
// neighbour of slot d, called only for a neighbour inside the box.  An
// invalid row loads nothing.  With `stream` the planes are loaded as
// streamed data (evicted from L2 first: a plane stack larger than L2 then
// leaves the caller's other vectors there).  The planes hold values of
// type V (load_plane).
template <typename T, int R, typename V, typename XAt>
__device__ __forceinline__ void row_partials(
    T (&acc)[R], const V* const (&vp)[R], int64_t box, const Slots& slots,
    int d_lo, int d_hi, const bool (&valid)[R], const int (&iz)[R],
    const int (&iy)[R], const int (&ix)[R], int nz, int ny, int nx,
    XAt xat, bool stream = false) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    acc[k] = T(0);
  }
  for (int d0 = d_lo; d0 < d_hi; d0 += kStage) {
    T v[R][kStage];
    T xv[R][kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int d = d0 + s;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        v[k][s] = T(0);
        xv[k][s] = T(0);
        if (valid[k] && d < d_hi) {
          const int z = iz[k] + slots.d[d][0];
          const int yy = iy[k] + slots.d[d][1];
          const int xx = ix[k] + slots.d[d][2];
          if ((unsigned)z < (unsigned)nz && (unsigned)yy < (unsigned)ny &&
              (unsigned)xx < (unsigned)nx) {
            v[k][s] = load_plane<T, V>(vp[k] + (int64_t)d * box, stream);
            xv[k][s] = xat(k, d);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[k] = fma(v[k][s], xv[k][s], acc[k]);
      }
    }
  }
}

// K1's partial row sum over slots [d_lo, d_hi) of row (iz, iy, ix) of an
// (nz, ny, nx) box: vp points at the row's value in slot 0's plane (planes
// `box` apart), xat(d) loads the neighbour of slot d, called only for a
// neighbour inside the box.  An invalid row loads nothing.
template <typename T, typename V, typename XAt>
__device__ __forceinline__ T row_partial(const V* vp, int64_t box,
                                         const Slots& slots, int d_lo,
                                         int d_hi, bool valid, int iz,
                                         int iy, int ix, int nz, int ny,
                                         int nx, XAt xat) {
  T acc[1];
  const V* const vps[1] = {vp};
  const bool valids[1] = {valid};
  const int izs[1] = {iz}, iys[1] = {iy}, ixs[1] = {ix};
  row_partials<T, 1>(acc, vps, box, slots, d_lo, d_hi, valids, izs, iys,
                     ixs, nz, ny, nx, [&](int, int d) { return xat(d); });
  return acc[0];
}

// K1's update epilogue c + w * s (.) (b - acc) for acc = (A x)[row], with
// b, s, c absent where their flags are false (b = 0, s = 1, c = 0), in the
// plain version's order (kernels/dia.py: epilogue_plain): t = b - acc (or
// acc), t = (w s) t (or w t), then c + t (c - t without b; -t without b
// or c)
template <typename T>
__device__ __forceinline__ T epilogue(T acc, bool hb, T b, bool hs, T s,
                                      bool hc, T c, T w) {
  T t = hb ? sub_rn(b, acc) : acc;
  t = hs ? mul_rn(mul_rn(w, s), t) : mul_rn(w, t);
  if (hc) {
    return hb ? add_rn(c, t) : sub_rn(c, t);
  }
  return hb ? t : -t;
}

// .75 a + .25 b, K3's step of the prolongation
template <typename T>
__device__ __forceinline__ T up(T a, T b) {
  return add_rn(mul_rn(T(0.75), a), mul_rn(T(0.25), b));
}

// .75 (e + o) + .25 lo + .25 hi, K3's step of the restriction
template <typename T>
__device__ __forceinline__ T down(T e, T o, T lo, T hi) {
  return add_rn(add_rn(mul_rn(T(0.75), add_rn(e, o)), mul_rn(T(0.25), lo)),
                mul_rn(T(0.25), hi));
}

// (P a)[iz, iy, ix] for the fine point (iz, iy, ix) of a coarse box
// (nz, ny, nx); a(z, y, x) loads a coarse value.  The z axis, then y,
// then x, as K3 and its plain version.
template <typename T, typename At>
__device__ __forceinline__ T prolong_point(At a, int iz, int iy, int ix,
                                           int nz, int ny, int nx) {
  // each axis: the coarse cell and its clamped neighbour on i's side
  const int cz = iz >> 1, cy = iy >> 1, cx = ix >> 1;
  const int nbz = (iz & 1) ? min(cz + 1, nz - 1) : max(cz - 1, 0);
  const int nby = (iy & 1) ? min(cy + 1, ny - 1) : max(cy - 1, 0);
  const int nbx = (ix & 1) ? min(cx + 1, nx - 1) : max(cx - 1, 0);
  const int ys[2] = {cy, nby};
  const int xs[2] = {cx, nbx};
  T v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    T u[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      u[j] = up(a(cz, ys[j], xs[k]), a(nbz, ys[j], xs[k]));  // along z
    }
    v[k] = up(u[0], u[1]);                                    // along y
  }
  return up(v[0], v[1]);                                      // along x
}

// the fine cells of coarse cell c's restriction window along an axis of
// coarse extent m: 2c, 2c+1, then 2c-1 and 2c+2, the edge cell standing in
// for a missing one
__device__ __forceinline__ void window(int c, int m, int w[4]) {
  w[0] = 2 * c;
  w[1] = 2 * c + 1;
  w[2] = c > 0 ? 2 * c - 1 : 2 * c;
  w[3] = c < m - 1 ? 2 * c + 2 : 2 * c + 1;
}

// the restriction of one coarse cell along z, then y, at the window's k-th
// x cell: at(m, j, k) loads the fine value at the window's m-th z, j-th y
// and k-th x cell
template <typename T, typename At>
__device__ __forceinline__ T restrict_zy(At at, int k) {
  T u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u[j] = down(at(0, j, k), at(1, j, k), at(2, j, k), at(3, j, k));
  }
  return down(u[0], u[1], u[2], u[3]);
}

// (P^T r) of one coarse cell: z, then y, then x
template <typename T, typename At>
__device__ __forceinline__ T restrict_point(At at) {
  T v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = restrict_zy<T>(at, k);
  }
  return down(v[0], v[1], v[2], v[3]);
}

}  // namespace box_cycle
