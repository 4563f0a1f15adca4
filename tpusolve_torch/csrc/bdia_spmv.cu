// Blocked-DIA (BDIA) sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces tpusolve/kernels/bdia.py:_bdia_kernel (the Pallas TPU kernel
// behind bdia_spmv_pallas).  It computes what that kernel computes, for
// every part p, R-row block b and row r of the block:
//
//     y[p, b*R + r] = sum_d vals[p, b, d, r] * x[p, starts[p, b, d] - xpad_lo + r]
//
// where x entries outside [0, col_pad) read as zero (the TPU kernel reads a
// zero-padded copy of x; here the bounds test replaces that copy, so no
// padded x is materialised per SpMV).  It also applies the overflow list,
// which tpusolve applies after the TPU kernel with a gather and a
// scatter-add (tpusolve/matrix/spmv.py:_ovf_wrap): row i adds
// ovf_vals[j] * x[ovf_cols[j]] for j in [ovf_ptr[i], ovf_ptr[i + 1]), after
// its slots and in list order, so the sum is deterministic and needs no
// atomics.  A null ovf_ptr means no overflow list.
//
// What bounds it: the values stream, B*D*R*itemsize bytes per part, read
// once.  The x windows are contiguous, overlap heavily between neighbouring
// slots and blocks of a banded (RCM-ordered) matrix, and are served from L2
// rather than device memory.  The design follows from that:
//   * one thread block per (part, R-row block): blockIdx.x = b, blockIdx.y = p;
//   * the block's window starts are staged once in shared memory (the role
//     of the TPU kernel's scalar-prefetched SMEM starts);
//   * each thread owns rows r = threadIdx.x, threadIdx.x + blockDim.x, ...
//     and accumulates over the slots d = 0..D-1 in slot order, so that a
//     warp's reads of vals[b, d, :] and of the x window are coalesced;
//   * offsets into vals are 64-bit (B*D*R passes 2^31 at production sizes);
//   * the overflow entries of a row are few (a correction, capped at an
//     eighth of the nonzeros), so its thread reads them one by one.
// The TPU kernel's lane roll and sublane select exist only to realign
// unaligned windows in VMEM; contiguous global loads need neither.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void bdia_spmv_kernel(const T* __restrict__ vals,
                                 const int32_t* __restrict__ starts,
                                 const T* __restrict__ x,
                                 const int32_t* __restrict__ ovf_ptr,
                                 const int32_t* __restrict__ ovf_cols,
                                 const T* __restrict__ ovf_vals,
                                 T* __restrict__ y,
                                 int nblocks, int nslots, int block_rows,
                                 int row_pad, int col_pad, int xpad_lo,
                                 int ovf_len) {
  extern __shared__ int32_t s_start[];   // nslots window starts, unpadded x
  const int b = blockIdx.x;
  const int p = blockIdx.y;
  const int64_t blk = (int64_t)p * nblocks + b;
  const int32_t* st = starts + blk * nslots;
  for (int d = threadIdx.x; d < nslots; d += blockDim.x) {
    s_start[d] = st[d] - xpad_lo;
  }
  __syncthreads();

  const T* v = vals + blk * (int64_t)nslots * block_rows;
  const T* xp = x + (int64_t)p * col_pad;
  T* yp = y + (int64_t)p * row_pad;
  for (int r = threadIdx.x; r < block_rows; r += blockDim.x) {
    const int row = b * block_rows + r;
    if (row >= row_pad) {
      break;   // rows only grow with r: the rest of the block is padding
    }
    T acc = T(0);
    for (int d = 0; d < nslots; ++d) {
      const int idx = s_start[d] + r;
      const T xv = (idx >= 0 && idx < col_pad) ? __ldg(xp + idx) : T(0);
      acc += v[(int64_t)d * block_rows + r] * xv;
    }
    if (ovf_ptr != nullptr) {
      const int32_t* pp = ovf_ptr + (int64_t)p * (row_pad + 1);
      const int32_t* oc = ovf_cols + (int64_t)p * ovf_len;
      const T* ov = ovf_vals + (int64_t)p * ovf_len;
      const int end = __ldg(pp + row + 1);
      for (int j = __ldg(pp + row); j < end; ++j) {
        acc += __ldg(ov + j) * __ldg(xp + __ldg(oc + j));
      }
    }
    yp[row] = acc;
  }
}

template <typename T>
int launch(const void* vals, const void* starts, const void* x,
           const void* ovf_ptr, const void* ovf_cols, const void* ovf_vals,
           void* y, int nparts, int nblocks, int nslots, int block_rows,
           int row_pad, int col_pad, int xpad_lo, int ovf_len, void* stream) {
  const int threads = block_rows < 256 ? block_rows : 256;
  const dim3 grid(nblocks, nparts);
  const size_t smem = (size_t)nslots * sizeof(int32_t);
  bdia_spmv_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)starts, (const T*)x,
      (const int32_t*)ovf_ptr, (const int32_t*)ovf_cols, (const T*)ovf_vals,
      (T*)y, nblocks, nslots, block_rows, row_pad, col_pad, xpad_lo, ovf_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bdia_spmv_f32(const void* vals, const void* starts, const void* x,
                  const void* ovf_ptr, const void* ovf_cols,
                  const void* ovf_vals, void* y, int nparts, int nblocks,
                  int nslots, int block_rows, int row_pad, int col_pad,
                  int xpad_lo, int ovf_len, void* stream) {
  return launch<float>(vals, starts, x, ovf_ptr, ovf_cols, ovf_vals, y,
                       nparts, nblocks, nslots, block_rows, row_pad, col_pad,
                       xpad_lo, ovf_len, stream);
}

int bdia_spmv_f64(const void* vals, const void* starts, const void* x,
                  const void* ovf_ptr, const void* ovf_cols,
                  const void* ovf_vals, void* y, int nparts, int nblocks,
                  int nslots, int block_rows, int row_pad, int col_pad,
                  int xpad_lo, int ovf_len, void* stream) {
  return launch<double>(vals, starts, x, ovf_ptr, ovf_cols, ovf_vals, y,
                        nparts, nblocks, nslots, block_rows, row_pad, col_pad,
                        xpad_lo, ovf_len, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
