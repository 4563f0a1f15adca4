// Blocked-DIA (BDIA) SpMV by x panels in shared memory, for Hopper (sm_90a).
//
// Replaces tpusolve/kernels/bdia.py:_bdia_kernel_xl (the Pallas TPU kernel
// behind bdia_spmv_pallas_xl), which DMAs one x panel per grid step of 8
// R-row blocks into VMEM.  It computes exactly what K4 (bdia_spmv.cu)
// computes, on the same values, starts and overflow list:
//
//     y[p, b*R + r] = sum_d vals[p, b, d, r] * x[p, starts[p, b, d] - xpad_lo + r]
//                     + sum_j ovf_vals[p, j] * x[p, ovf_cols[p, j]]
//
// with x entries outside [0, col_pad) read as 0, the slots summed in slot
// order and then the overflow entries in list order, one multiply-add each,
// as K4 sums them: y is K4's bit for bit, so a solve cannot tell them apart.
//
// What bounds it: the values stream, B*D*R*itemsize bytes per part, read
// once, and the overflow list.  K4 reads each window from L1/L2, one
// 4-byte load of a value and one of x per slot and row, and reached 0.35-
// 0.49 of HBM peak on the 96^3 gate-4 ILU factors in f32.  The design:
//   * one thread block per (part, step), step = gb consecutive R-row blocks
//     (blockIdx.x = step, blockIdx.y = part); the host's step plan gives
//     each step's panel start step_lo (a multiple of 4 elements, may be
//     negative) and one panel length for all steps (a multiple of 4);
//   * the step's panel of x is copied into dynamic shared memory by one TMA
//     1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx) that completes
//     on an mbarrier; the copy covers the 16-byte units inside [0, col_pad),
//     and the threads fill the rest: x's tail past the last whole unit, and
//     zeros outside [0, col_pad).  Where x's base is not 16-byte aligned
//     (a view such as buf[1:]) the threads copy the whole panel themselves;
//   * the step's window offsets into the panel are staged in shared memory;
//   * up to 1024 threads; a warp owns 32 * kRows consecutive rows of one
//     block per pass (128 in f32, 64 in f64), a lane the rows 32 apart, so
//     that a warp's loads of a slot's values are one coalesced line each
//     (evict-first: they are read once) and its reads of the window from
//     the panel hit 32 consecutive banks; the slot loop is unrolled by 4,
//     so kRows * 4 value loads are in flight per thread;
//   * each row's first overflow entry (value, and x at its column) is
//     loaded before the slots, behind the panel copy on the first pass, and
//     added after them; the rest of the list follows in order;
//   * offsets into vals are 64-bit (B*D*R passes 2^31 at production sizes).
// On the chip, against variants of this design: the bulk copy as one
// request, as 4 or 16 KB pieces or as per-thread cp.async 16-byte copies
// timed the same; loads of the first slots' values before the panel
// arrived, and two row groups per thread, were slower; 16-byte vector loads
// of 4 consecutive rows a thread were slower than rows 32 apart, whose
// overflow reads coalesce (PERF.md).  Rounds of blocks matter most:
// a K5 block holds one panel of up to 227 KB, so an SM often holds one
// block, and the step plan prices a partly empty last round as a full one.
// The shared memory above 48 KB is opted in per instantiation with
// cudaFuncSetAttribute before the first launch that needs it.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;    // kernels/bdia.py: XL_THREADS
constexpr int kPre = 1;              // overflow entries per row loaded early
constexpr int kBarrierBytes = 16;    // kernels/bdia.py: XL_BARRIER_BYTES
constexpr int kAlign = 4;            // kernels/bdia.py: XL_ALIGN, elements
constexpr int kRowBytes = 16;        // kernels/bdia.py: XL_ROW_BYTES
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
bdia_spmv_xl_kernel(const T* __restrict__ vals,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ step_lo,
                    const T* __restrict__ x,
                    const int32_t* __restrict__ ovf_ptr,
                    const int32_t* __restrict__ ovf_cols,
                    const T* __restrict__ ovf_vals,
                    T* __restrict__ y,
                    int nblocks, int nslots, int block_rows, int row_pad,
                    int col_pad, int xpad_lo, int ovf_len, int gb, int nsteps,
                    int panel) {
  constexpr int kRows = kRowBytes / sizeof(T);   // rows per thread and pass
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* s_x = reinterpret_cast<T*>(smem + kBarrierBytes);
  int32_t* s_off = reinterpret_cast<int32_t*>(
      smem + kBarrierBytes + (size_t)panel * sizeof(T));

  const int step = blockIdx.x;
  const int p = blockIdx.y;
  const int b0 = step * gb;
  const int nb = min(gb, nblocks - b0);
  const T* xp = x + (int64_t)p * col_pad;
  const int lo = step_lo[(int64_t)p * nsteps + step];

  // the part of the panel the bulk copy moves: whole 16-byte units of x
  const int c_lo = max(lo, 0);
  const int c_hi = min(lo + panel, col_pad - col_pad % kAlign);
  const bool bulk = c_hi > c_lo && (reinterpret_cast<uintptr_t>(xp) % 16) == 0;
  const uint32_t bar_addr = smem_u32(bar);
  if (bulk && threadIdx.x == 0) {
    mbar_init(bar_addr, 1);
  }
  __syncthreads();
  if (bulk && threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)(c_hi - c_lo) * sizeof(T);
    mbar_expect_tx(bar_addr, bytes);
    bulk_copy_g2s(smem_u32(s_x + (c_lo - lo)), xp + c_lo, bytes, bar_addr);
  }
  // the threads: window offsets, and the panel outside the bulk copy
  const int32_t* st = starts + ((int64_t)p * nblocks + b0) * nslots;
  for (int i = threadIdx.x; i < nb * nslots; i += blockDim.x) {
    s_off[i] = st[i] - xpad_lo - lo;
  }
  // panel entries [copy_lo, copy_hi) are the bulk copy's, the rest ours
  const int copy_lo = bulk ? c_lo - lo : panel;
  const int copy_hi = bulk ? c_hi - lo : panel;
  for (int i = threadIdx.x; i < copy_lo; i += blockDim.x) {
    const int g = lo + i;
    s_x[i] = (g >= 0 && g < col_pad) ? xp[g] : T(0);
  }
  for (int i = copy_hi + threadIdx.x; i < panel; i += blockDim.x) {
    const int g = lo + i;
    s_x[i] = (g >= 0 && g < col_pad) ? xp[g] : T(0);
  }
  __syncthreads();

  // Rows.  Per pass, warp w owns the 32 * kRows rows from base + w * 32 *
  // kRows, one R-row block's (R is a multiple of 128), and its lane owns
  // rows lane, lane + 32, ...: a warp's loads of a slot's values, and its
  // reads of the slot's window from the panel, are consecutive.
  const int32_t* pp = ovf_ptr + (int64_t)p * (row_pad + 1);
  const int32_t* oc = ovf_cols + (int64_t)p * ovf_len;
  const T* ov = ovf_vals + (int64_t)p * ovf_len;
  T* yp = y + (int64_t)p * row_pad;
  const int nrows = nb * block_rows;
  const int lane = threadIdx.x % 32;
  bool waited = !bulk;
  for (int base = (threadIdx.x / 32) * 32 * kRows; base < nrows;
       base += blockDim.x * kRows) {
    const int k = base / block_rows;                 // block within the step
    const int r0 = base - k * block_rows + lane;     // row in the block, j = 0
    const int row0 = (b0 + k) * block_rows + r0;     // global row, j = 0
    // the first kPre overflow entries of each row, loaded now so that their
    // latency hides behind the panel copy (first pass) and the slots
    int e_beg[kRows], e_end[kRows];
    T pre_v[kRows][kPre], pre_x[kRows][kPre];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = row0 + 32 * j;
      e_beg[j] = e_end[j] = 0;
      if (ovf_ptr != nullptr && row < row_pad) {
        e_beg[j] = __ldg(pp + row);
        e_end[j] = __ldg(pp + row + 1);
      }
#pragma unroll
      for (int q = 0; q < kPre; ++q) {
        const int e = e_beg[j] + q;
        pre_v[j][q] = T(0);
        pre_x[j][q] = T(0);
        if (e < e_end[j]) {
          pre_v[j][q] = __ldg(ov + e);
          pre_x[j][q] = __ldg(xp + __ldg(oc + e));
        }
      }
    }
    if (!waited) {
      while (!mbar_try_wait(bar_addr, 0)) {
      }
      waited = true;
    }
    if (row0 >= row_pad) {
      continue;   // the whole 32-row group of j = 0 and beyond is padding
    }
    const T* v = vals + ((int64_t)p * nblocks + b0 + k) * nslots * block_rows
                 + r0;
    const int32_t* off = s_off + k * nslots;
    T acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      acc[j] = T(0);
    }
#pragma unroll 4
    for (int d = 0; d < nslots; ++d) {
      const T* vd = v + (int64_t)d * block_rows;
      const T* xw = s_x + off[d] + r0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        acc[j] += __ldcs(vd + 32 * j) * xw[32 * j];
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = row0 + 32 * j;
      if (row >= row_pad) {
        break;
      }
#pragma unroll
      for (int q = 0; q < kPre; ++q) {
        if (e_beg[j] + q < e_end[j]) {
          acc[j] += pre_v[j][q] * pre_x[j][q];
        }
      }
      for (int e = e_beg[j] + kPre; e < e_end[j]; ++e) {
        acc[j] += __ldg(ov + e) * __ldg(xp + __ldg(oc + e));
      }
      yp[row] = acc[j];
    }
  }
  if (!waited) {
    while (!mbar_try_wait(bar_addr, 0)) {   // never leave a copy in flight
    }
  }
}

template <typename T>
int launch(const void* vals, const void* starts, const void* step_lo,
           const void* x, const void* ovf_ptr, const void* ovf_cols,
           const void* ovf_vals, void* y, int nparts, int nblocks, int nslots,
           int block_rows, int row_pad, int col_pad, int xpad_lo, int ovf_len,
           int gb, int nsteps, int panel, void* stream) {
  const int groups = gb * block_rows / (kRowBytes / (int)sizeof(T));
  const int warps32 = (groups + 31) / 32 * 32;
  const int threads = warps32 < kMaxThreads ? warps32 : kMaxThreads;
  const size_t smem = kBarrierBytes + (size_t)panel * sizeof(T)
                      + (size_t)gb * nslots * sizeof(int32_t);
  // opt in to the shared memory above the default 48 KB, once per device
  static size_t opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return (int)err;
  }
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > opted[dev])) {
    err = cudaFuncSetAttribute(bdia_spmv_xl_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      return (int)err;
    }
    if (dev < kMaxDevices) {
      opted[dev] = smem;
    }
  }
  const dim3 grid(nsteps, nparts);
  bdia_spmv_xl_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)starts, (const int32_t*)step_lo,
      (const T*)x, (const int32_t*)ovf_ptr, (const int32_t*)ovf_cols,
      (const T*)ovf_vals, (T*)y, nblocks, nslots, block_rows, row_pad,
      col_pad, xpad_lo, ovf_len, gb, nsteps, panel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bdia_spmv_xl_f32(const void* vals, const void* starts, const void* step_lo,
                     const void* x, const void* ovf_ptr, const void* ovf_cols,
                     const void* ovf_vals, void* y, int nparts, int nblocks,
                     int nslots, int block_rows, int row_pad, int col_pad,
                     int xpad_lo, int ovf_len, int gb, int nsteps, int panel,
                     void* stream) {
  return launch<float>(vals, starts, step_lo, x, ovf_ptr, ovf_cols, ovf_vals,
                       y, nparts, nblocks, nslots, block_rows, row_pad,
                       col_pad, xpad_lo, ovf_len, gb, nsteps, panel, stream);
}

int bdia_spmv_xl_f64(const void* vals, const void* starts, const void* step_lo,
                     const void* x, const void* ovf_ptr, const void* ovf_cols,
                     const void* ovf_vals, void* y, int nparts, int nblocks,
                     int nslots, int block_rows, int row_pad, int col_pad,
                     int xpad_lo, int ovf_len, int gb, int nsteps, int panel,
                     void* stream) {
  return launch<double>(vals, starts, step_lo, x, ovf_ptr, ovf_cols, ovf_vals,
                        y, nparts, nblocks, nslots, block_rows, row_pad,
                        col_pad, xpad_lo, ovf_len, gb, nsteps, panel, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
