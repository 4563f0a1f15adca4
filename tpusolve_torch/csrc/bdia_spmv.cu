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
// atomics.  A null ovf_ptr means no overflow list.  Each row is summed by
// one thread, slots in order, one fused multiply-add a slot, then the
// overflow in list order: the order K5 (bdia_spmv_xl.cu) sums in, so the
// two give the same y bit for bit.
//
// What bounds it: the values stream, B*D*R*itemsize bytes per part, read
// once.  The x windows are contiguous, overlap between neighbouring slots
// and blocks of a banded (RCM-ordered) matrix, and are served from L1/L2.
// A row's sum is a chain over D slots, each slot a value from device
// memory and an x entry from L1/L2, so the kernel is bound by the loads
// each thread keeps in flight, and on a small launch (an AMG coarse level:
// 21,588 rows and D=688 at gate 3's 64^3 level 1, 5 warps an SM) by
// nothing else.  The first version looped over the slots with the
// compiler's unrolling and ran that level at 0.31 of its bound on an
// H100.  The design:
//   * a thread block per (part, chunk of Rc rows of one R-row block),
//     blockIdx.x = b * (R / Rc) + chunk, blockIdx.y = p, one thread a row
//     (kernels/bdia.py:k4_plan: Rc = min(R, 256)); a chunk wholly past
//     row_pad returns at once.  Splitting a block's rows into more, smaller
//     chunks to put more blocks on the SMs of a small launch measured no
//     faster on the card: the chunks of one R-row block then fetch the
//     block's x windows into several SMs' L1;
//   * the slots run in stages of S: a stage's values (streaming loads,
//     read once) and x entries, 2 * S independent loads, are all issued
//     before its S multiply-adds.  The host picks S (k4_plan): 8 where
//     the launch has warps enough to fill the SMs, 32 on a small launch,
//     which has few warps and needs each deep.  Loading stage k + 1 before
//     the multiply-adds of stage k (two register sets) measured no faster
//     on the full launches and little faster on the small ones;
//   * the window starts are staged once in shared memory; x is read through
//     __ldg with a bounds test;
//   * each row's first overflow entry (value, and x at its column) is
//     loaded before the slots and added after them, the rest in order;
//   * offsets into vals are 64-bit (B*D*R passes 2^31 at production sizes).
// On the card, the alternative design, the values streamed through a ring
// of shared-memory stages by TMA bulk copies (one copy a slot's chunk, an
// mbarrier a stage), x loaded a stage ahead, was slower than these
// register stages on every operator measured (PERF.md): its buffers take
// the SM's L1, which the x windows need, and its block barrier a stage
// stalls the warps.  The shared memory above 48 KB (D above 12,288) is
// opted in per instantiation before the first launch that needs it.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;     // kernels/bdia.py: K4_MAX_CHUNK
constexpr int kMaxDevices = 64;

// The values and the x entries of stage k's S slots for row r, into
// registers: the loads are independent, so all 2 * S are in flight at once
template <typename T, int S>
__device__ __forceinline__ void load_stage(T (&vv)[S], T (&xv)[S], int k,
                                           const T* vr,
                                           const int32_t* s_start,
                                           int nslots, int block_rows, int r,
                                           const T* xp, int col_pad) {
  const int d0 = k * S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (d0 + j < nslots) {
      vv[j] = __ldcs(vr + (int64_t)(d0 + j) * block_rows);
      const int idx = s_start[d0 + j] + r;
      xv[j] = (idx >= 0 && idx < col_pad) ? __ldg(xp + idx) : T(0);
    }
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kMaxThreads)
bdia_spmv_kernel(const T* __restrict__ vals,
                 const int32_t* __restrict__ starts,
                 const T* __restrict__ x,
                 const int32_t* __restrict__ ovf_ptr,
                 const int32_t* __restrict__ ovf_cols,
                 const T* __restrict__ ovf_vals,
                 T* __restrict__ y,
                 int nblocks, int nslots, int block_rows, int row_pad,
                 int col_pad, int xpad_lo, int ovf_len, int chunk_rows) {
  extern __shared__ int32_t s_start[];   // nslots window starts, unpadded x
  const int nchunks = block_rows / chunk_rows;
  const int b = blockIdx.x / nchunks;
  const int r0 = (blockIdx.x - b * nchunks) * chunk_rows;
  const int p = blockIdx.y;
  if (b * block_rows + r0 >= row_pad) {
    return;   // the whole chunk is padding (uniform over the block)
  }
  const int64_t blk = (int64_t)p * nblocks + b;
  const int32_t* st = starts + blk * nslots;
  for (int d = threadIdx.x; d < nslots; d += blockDim.x) {
    s_start[d] = st[d] - xpad_lo;
  }
  // the row's first overflow entry, loaded now: its latency hides behind
  // the slots (loading more entries early measured no faster)
  const int r = r0 + threadIdx.x;
  const int row = b * block_rows + r;
  const bool live = row < row_pad;
  const T* xp = x + (int64_t)p * col_pad;
  const int32_t* oc = ovf_cols + (int64_t)p * ovf_len;
  const T* ov = ovf_vals + (int64_t)p * ovf_len;
  int e_beg = 0, e_end = 0;
  T pre_v = T(0), pre_x = T(0);
  if (ovf_ptr != nullptr && live) {
    const int32_t* pp = ovf_ptr + (int64_t)p * (row_pad + 1);
    e_beg = __ldg(pp + row);
    e_end = __ldg(pp + row + 1);
    if (e_beg < e_end) {
      pre_v = __ldg(ov + e_beg);
      pre_x = __ldg(xp + __ldg(oc + e_beg));
    }
  }
  __syncthreads();

  // Stages of S slots: a stage's values and x entries, 2 * S independent
  // loads, are all issued before its multiply-adds, one slot after
  // another in slot order
  const int nst = (nslots + S - 1) / S;
  const T* vr = vals + blk * nslots * (int64_t)block_rows + r;
  T acc = T(0);
  for (int k = 0; k < nst; ++k) {
    T vv[S], xv[S];
    load_stage<T, S>(vv, xv, k, vr, s_start, nslots, block_rows, r, xp,
                     col_pad);
    const int d0 = k * S;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (d0 + j < nslots) {
        acc += vv[j] * xv[j];
      }
    }
  }
  if (live) {
    if (e_beg < e_end) {
      acc += pre_v * pre_x;
      for (int e = e_beg + 1; e < e_end; ++e) {
        acc += __ldg(ov + e) * __ldg(xp + __ldg(oc + e));
      }
    }
    y[(int64_t)p * row_pad + row] = acc;
  }
}

template <typename T, int S>
int launch_s(const void* vals, const void* starts, const void* x,
             const void* ovf_ptr, const void* ovf_cols, const void* ovf_vals,
             void* y, int nparts, int nblocks, int nslots, int block_rows,
             int row_pad, int col_pad, int xpad_lo, int ovf_len,
             int chunk_rows, void* stream) {
  const size_t smem = (size_t)nslots * sizeof(int32_t);
  // opt in to the shared memory above the default 48 KB, once per device
  static size_t opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return (int)err;
  }
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > opted[dev])) {
    err = cudaFuncSetAttribute(bdia_spmv_kernel<T, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      return (int)err;
    }
    if (dev < kMaxDevices) {
      opted[dev] = smem;
    }
  }
  const dim3 grid(nblocks * (block_rows / chunk_rows), nparts);
  bdia_spmv_kernel<T, S><<<grid, chunk_rows, smem, (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)starts, (const T*)x,
      (const int32_t*)ovf_ptr, (const int32_t*)ovf_cols, (const T*)ovf_vals,
      (T*)y, nblocks, nslots, block_rows, row_pad, col_pad, xpad_lo, ovf_len,
      chunk_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* starts, const void* x,
           const void* ovf_ptr, const void* ovf_cols, const void* ovf_vals,
           void* y, int nparts, int nblocks, int nslots, int block_rows,
           int row_pad, int col_pad, int xpad_lo, int ovf_len, int chunk_rows,
           int stage_slots, void* stream) {
  if (chunk_rows <= 0 || chunk_rows > kMaxThreads
      || block_rows % chunk_rows) {
    return (int)cudaErrorInvalidValue;
  }
#define TPUSOLVE_K4_LAUNCH(SLOTS)                                          \
  launch_s<T, SLOTS>(vals, starts, x, ovf_ptr, ovf_cols, ovf_vals, y,       \
                     nparts, nblocks, nslots, block_rows, row_pad, col_pad, \
                     xpad_lo, ovf_len, chunk_rows, stream)
  switch (stage_slots) {   // kernels/bdia.py: K4_SLOTS
    case 8: return TPUSOLVE_K4_LAUNCH(8);
    case 16: return TPUSOLVE_K4_LAUNCH(16);
    case 32: return TPUSOLVE_K4_LAUNCH(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TPUSOLVE_K4_LAUNCH
}

}  // namespace

extern "C" {

int bdia_spmv_f32(const void* vals, const void* starts, const void* x,
                  const void* ovf_ptr, const void* ovf_cols,
                  const void* ovf_vals, void* y, int nparts, int nblocks,
                  int nslots, int block_rows, int row_pad, int col_pad,
                  int xpad_lo, int ovf_len, int chunk_rows, int stage_slots,
                  void* stream) {
  return launch<float>(vals, starts, x, ovf_ptr, ovf_cols, ovf_vals, y,
                       nparts, nblocks, nslots, block_rows, row_pad, col_pad,
                       xpad_lo, ovf_len, chunk_rows, stage_slots, stream);
}

int bdia_spmv_f64(const void* vals, const void* starts, const void* x,
                  const void* ovf_ptr, const void* ovf_cols,
                  const void* ovf_vals, void* y, int nparts, int nblocks,
                  int nslots, int block_rows, int row_pad, int col_pad,
                  int xpad_lo, int ovf_len, int chunk_rows, int stage_slots,
                  void* stream) {
  return launch<double>(vals, starts, x, ovf_ptr, ovf_cols, ovf_vals, y,
                        nparts, nblocks, nslots, block_rows, row_pad, col_pad,
                        xpad_lo, ovf_len, chunk_rows, stage_slots, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
