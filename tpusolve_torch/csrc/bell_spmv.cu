// Block-ELL (BELL) sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces tpusolve/kernels/bell.py:159 _bell_kernel (the Pallas TPU kernel
// behind bell_spmv_pallas).  It computes what that kernel computes, for
// every part p, 8-row group g and row r of the group:
//
//     y[p, 8g + r] = sum_k sum_c vals[p, g, k, r, c] * x[p, ids[p, g, k]*128 + c]
//
// for c in [0, 128), with x entries at or past col_pad read as zero (the TPU
// kernel reads a zero-padded (nwin, 128) copy of x; here a bounds test
// replaces that copy).  Rows at or past row_pad are not stored, so y is
// trimmed to row_pad as bell.py trims it.  Padding tiles (window 0, zero
// values) add zero.
//
// What bounds it: the tile stream, G*K*8*128*itemsize bytes per part, read
// once.  Tiles are mostly zeros (2-16 % fill on AMG coarse levels), so the
// kernel streams about 6-50 bytes for every useful one.  x is small on the
// levels that take this layout and is served from L2.  The first version
// of this kernel ran one warp per group, 4 warps a block, each warp walking
// its K tiles one after another: gate 3's level 2 at 64^3 (189 groups,
// K=12) was 48 blocks on 132 SMs, 189 warps each streaming 12 tiles in
// turn, at 0.55 of its bound on an H100.  This design spreads the tiles:
//   * one thread block per (group, part), W = min(K, 16) warps
//     (kernels/bell.py:bell_warps); warp w takes tiles k = w, w + W, ...,
//     so a level of G groups exposes G*W warps (2,268 at level 2);
//   * each lane owns 4 consecutive columns of the 128-wide window, and per
//     tile issues the loads of its 4 values of x and of its 4 values of
//     each of the 8 tile rows (one 16-byte load per row in f32, two in
//     f64) before any multiply-add, so a warp has a whole 4 or 8 KB tile
//     in flight, and each 128-wide tile row is one contiguous 512- or
//     1024-byte segment of the warp's loads;
//   * 8 accumulators per lane over the warp's tiles, a butterfly
//     warp-shuffle reduction of each, then the W warps' partial sums of
//     the 8 rows are added in shared memory in warp order (fixed: the
//     result is deterministic), and threads 0-7 store rows 0-7;
//   * x loads are 16 bytes when x's part is 16-byte aligned and the 4
//     columns lie inside x, else 4 scalar loads with the bounds test.
// Skipping all-zero sub-tiles would cut the stream (and the bound); that is
// later work (ROADMAP Queue 2).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;          // tile rows
constexpr int TN = 128;        // tile columns
constexpr int MAX_WARPS = 16;  // warps per thread block (kernels/bell.py)

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
bell_spmv_kernel(const T* __restrict__ vals, const int32_t* __restrict__ ids,
                 const T* __restrict__ x, T* __restrict__ y, int ngroups,
                 int ktiles, int row_pad, int col_pad) {
  __shared__ T s_part[MAX_WARPS][TM];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int g = blockIdx.x;
  const int p = blockIdx.y;
  const int64_t grp = (int64_t)p * ngroups + g;
  const int32_t* gid = ids + grp * ktiles;
  const T* gv = vals + grp * ktiles * (TM * TN) + lane * 4;
  const T* xp = x + (int64_t)p * col_pad;
  const bool xvec = (reinterpret_cast<uintptr_t>(xp) & 15) == 0;

  T acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    acc[r] = T(0);
  }
  for (int k = w; k < ktiles; k += nw) {
    const T* tv = gv + (int64_t)k * (TM * TN);
    T v[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      load4(tv + r * TN, v[r]);
    }
    const int c = __ldg(gid + k) * TN + lane * 4;
    T xv[4];
    if (xvec && c + 4 <= col_pad) {
      load4(xp + c, xv);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = (c + i < col_pad) ? __ldg(xp + c + i) : T(0);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      acc[r] += v[r][0] * xv[0] + v[r][1] * xv[1] + v[r][2] * xv[2]
                + v[r][3] * xv[3];
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
  }
  if (lane < TM) {
    T out = acc[0];
#pragma unroll
    for (int r = 1; r < TM; ++r) {
      if (lane == r) {
        out = acc[r];
      }
    }
    s_part[w][lane] = out;
  }
  __syncthreads();
  const int row = g * TM + threadIdx.x;
  if (threadIdx.x < TM && row < row_pad) {
    T out = s_part[0][threadIdx.x];
    for (int i = 1; i < nw; ++i) {
      out += s_part[i][threadIdx.x];
    }
    y[(int64_t)p * row_pad + row] = out;
  }
}

template <typename T>
int launch(const void* vals, const void* ids, const void* x, void* y,
           int nparts, int ngroups, int ktiles, int row_pad, int col_pad,
           int warps, void* stream) {
  if (warps <= 0 || warps > MAX_WARPS) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(ngroups, nparts);
  bell_spmv_kernel<T><<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)ids, (const T*)x, (T*)y, ngroups,
      ktiles, row_pad, col_pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bell_spmv_f32(const void* vals, const void* ids, const void* x, void* y,
                  int nparts, int ngroups, int ktiles, int row_pad,
                  int col_pad, int warps, void* stream) {
  return launch<float>(vals, ids, x, y, nparts, ngroups, ktiles, row_pad,
                       col_pad, warps, stream);
}

int bell_spmv_f64(const void* vals, const void* ids, const void* x, void* y,
                  int nparts, int ngroups, int ktiles, int row_pad,
                  int col_pad, int warps, void* stream) {
  return launch<double>(vals, ids, x, y, nparts, ngroups, ktiles, row_pad,
                        col_pad, warps, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
