// Blocked-DIA (BDIA) SpMV by x panels in shared memory, for Hopper (sm_90a):
// K5.
//
// Replaces tpusolve/kernels/bdia.py:_bdia_kernel_xl (the Pallas TPU kernel
// behind bdia_spmv_pallas_xl), which DMAs one x panel per grid step of 8
// R-row blocks into VMEM.  It computes exactly what K4 (bdia_spmv.cu)
// computes, on the same values, starts and overflow list:
//
//     (A x)[p, b*R + r] = sum_d vals[p, b, d, r] * x[p, starts[p, b, d] - xpad_lo + r]
//                         + sum_j ovf_vals[p, j] * x[p, ovf_cols[p, j]]
//
// with x entries outside [0, col_pad) read as 0, the slots summed in slot
// order and then the overflow entries in list order, one multiply-add each,
// as K4 sums them: A x is K4's bit for bit (for finite x), so a solve cannot
// tell them apart.  One launch also computes the update form
//
//     y = c + w * s (.) (b - A x)
//
// with any of b, s, c absent (null), each step rounded apart as the plain
// version computes it (csrc/box_cycle.cuh: epilogue; the Jacobi sweeps of
// the ILU apply, ilu/ilu.py).  y may be b, s or c, never x.
//
// What bounds it: the bytes it reads.  On gate 4's ILU factors half the
// slot values are zeros, and the overflow list (1.6 entries a row) crowds
// into some regions of the rows: at 96^3 a step of 53 blocks held from 0 to
// 38,000 entries.  The design:
//   * one thread block per (part, step), a step being consecutive R-row
//     blocks: [step_b0[p, i], step_b0[p, i + 1]), where the host's plan
//     balances the steps by the bytes K5 reads (kernels/bdia.py:
//     plan_steps); at most kAccRows rows a thread (blockIdx.x = step,
//     blockIdx.y = part).  The plan also gives each step's panel start
//     step_lo (a multiple of 4 elements, may be negative) and one panel
//     length for all steps (a multiple of 4);
//   * the step's panel of x is copied into dynamic shared memory by one TMA
//     1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx) that completes
//     on an mbarrier; the copy covers the 16-byte units inside [0, col_pad),
//     and the threads fill the rest: x's tail past the last whole unit, and
//     zeros outside [0, col_pad).  Where x's base is not 16-byte aligned
//     (a view such as buf[1:]) the threads copy the whole panel themselves.
//     The panel keeps each slot's x window, as many bytes as its values,
//     off L2;
//   * the step's window offsets into the panel, and its rows of the segment
//     mask, are staged in shared memory.  The mask (kernels/bdia.py:
//     segment_mask) has bit q of byte (b, d, q / 8) set where rows 32q ...
//     32q + 31 of slot d of block b hold a nonzero value (every bit set
//     where the values are not known: kernels/bdia.py: full_mask);
//   * up to 1024 threads; in pass ps a warp owns 32 * kRows consecutive
//     rows of one block (128 in f32, 64 in f64), a lane the rows 32 apart,
//     so that a warp's loads of a slot's values are one coalesced line each
//     (evict-first: they are read once) and its reads of the window from
//     the panel hit 32 consecutive banks.  Row group j of the warp is one
//     mask bit, uniform over the warp: a segment whose bit is clear loads
//     nothing and adds 0 * x, which leaves the sum's bits as they are.  The
//     loads are predicated, not branched around, so those of the slot loop
//     (unrolled by 4) issue together; the first kPreSlots slots' loads of
//     the first pass issue before the wait for the panel;
//   * the overflow, staged by the block: the step's entries are one span of
//     the CSR list, [ovf_ptr[first row], ovf_ptr[last row + 1]), copied
//     into shared memory (columns and values) in chunks of `stage` entries
//     by bulk copies, the first issued with the panel's so that it arrives
//     during the slots.  After the slots each thread adds its rows' entries
//     of each chunk in list order, x at the column from the panel (from
//     global memory where the column lies outside it): K4's order.  A
//     thread keeps the sums of all its rows across the passes;
//   * offsets into vals are 64-bit (B*D*R passes 2^31 at production sizes).
// On the chip, against variants of this design (PERF.md; calibrate --k5):
// the parent's (every segment read, each lane walking its own row's
// overflow entries after the slots), the mask alone, the overflow read by
// the warp in coalesced rounds of 32 with shuffles, the overflow staged
// pass by pass into two buffers, steps of equal blocks, and no or 8 slots
// loaded before the panel's wait were all slower.  Earlier: the bulk copy
// as one request, as 4 or 16 KB pieces or as per-thread cp.async copies
// timed the same; 16-byte vector loads of 4 consecutive rows a thread were
// slower than rows 32 apart; one persistent block per SM sliding an x ring
// was slower on every operator.  The shared memory above 48 KB is opted in
// per instantiation with cudaFuncSetAttribute before the first launch that
// needs it.
//
// The k-column form (the coupled multi-component solve, KC = 1 .. 8
// columns a launch, a template parameter; KC = 1 is the single-vector
// kernel): the values, the window offsets, the mask and the overflow are
// read once for all columns, and each thread keeps KC sums a row.  To keep
// those in registers a k-column block has at most kColThreads threads and
// kMaxThreads / kColThreads blocks an SM, one pass of kRows rows each for
// KC >= 3 (f64: two passes at KC = 2), so its steps hold fewer rows
// (kernels/bdia.py: xl_step_rows; the host plans them anew for k).  k
// panels of a step's span do not fit: on gate 4's factors a span is about
// 17,000 entries around a step's 2,048 rows, and the first design (k span
// panels as far as they fit) took 0.40 ms for three columns of L where
// three single launches take 0.10 (PERF.md).  The span is mostly
// the gaps between the band's three clusters of windows: a step's windows
// cover about 4,000 entries.  So each column stages only that cover: the
// host merges a step's windows into a few segments of x (kernels/bdia.py:
// step_cover, cov: 2.7 a step on gate 4's factors), packed one after
// another into the column's panel, and gives each window its offset there
// (cov.xoff, in place of its start) and each overflow entry its offset or,
// where no segment holds its column, -(column + 1) (cover_overflow, in
// place of the list's columns).  Thread 0 copies every segment of every
// column by TMA bulk copies on the panel's mbarrier, the threads the
// entries outside [0, col_pad) and x's unaligned tail, and the first
// slots' values load during the copies, as in the single form.  Without a
// panel, the columns had read x through the read-only path: 0.072 ms for
// three columns of gate 4's L at 96^3, 0.046 with the cover (512 threads a
// block; 256 and 1,024 timed 0.062 and 0.048, and the overflow's x read
// from x 0.049; calibrate --kcols, PERF.md).  Every column sums its slots
// in slot order and its overflow entries in list order, one multiply-add
// each, exactly as the single form: column j of a launch is the
// single-vector kernel on column j bit for bit.  The columns of x are xs_c
// apart, those of y, b and c ys_c apart (s is one vector for all columns).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "box_cycle.cuh"

namespace {

constexpr int kMaxThreads = 1024;    // kernels/bdia.py: XL_THREADS
constexpr int kBarrierBytes = 16;    // kernels/bdia.py: XL_BARRIER_BYTES
constexpr int kAlign = 4;            // kernels/bdia.py: XL_ALIGN, elements
constexpr int kRowBytes = 16;        // kernels/bdia.py: XL_ROW_BYTES
constexpr int kSegRows = 32;         // kernels/bdia.py: SEG_ROWS
constexpr int kAccRows = 8;          // kernels/bdia.py: XL_ACC_ROWS
constexpr int kPreSlots = 4;         // slots loaded before the panel's wait
constexpr int kMaxDevices = 64;
constexpr int kMaxCols = 8;          // kernels/bdia.py: XL_MAX_COLS
// the k-column form's threads a block (kernels/bdia.py: XL_COL_THREADS; a
// build flag that kernels/calibrate.py --kcols sets to compare others)
#ifndef TPUSOLVE_XL_COL_THREADS
#define TPUSOLVE_XL_COL_THREADS 512
#endif
constexpr int kColThreads = TPUSOLVE_XL_COL_THREADS;

// threads a block at most, blocks an SM must hold (so registers a thread:
// those of kMaxThreads threads in either form), and passes of kRows rows a
// thread, of the KC-column kernel on values of `bytes` bytes
__host__ __device__ constexpr int max_threads(int KC) {
  return KC == 1 ? kMaxThreads : kColThreads;
}
__host__ __device__ constexpr int min_blocks(int KC) {
  return KC == 1 ? 1 : kMaxThreads / kColThreads;
}
__host__ __device__ constexpr int passes(int KC, int bytes) {
  return KC == 1 ? kAccRows / (kRowBytes / bytes)
                 : (kAccRows / (kRowBytes / bytes) / KC > 0
                        ? kAccRows / (kRowBytes / bytes) / KC : 1);
}

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// The pointers and factor of the update form c + w * s (.) (b - A x)
template <typename T>
struct Update {
  const T* b;
  const T* s;
  const T* c;
  T w;
  // row i of the column whose b and c start `col` entries in (s is one
  // vector for all columns)
  __device__ __forceinline__ T operator()(T acc, int64_t i,
                                          int64_t col = 0) const {
    if (b == nullptr && s == nullptr && c == nullptr) {
      return acc;
    }
    return box_cycle::epilogue(acc, b != nullptr, b ? b[col + i] : T(0),
                               s != nullptr, s ? s[i] : T(0), c != nullptr,
                               c ? c[col + i] : T(0), w);
  }
};

// The overflow entries [lo, hi) of the list (columns oc, values ov) into
// the staging arrays s_oc, s_ov at index e - lo (lo a multiple of 4): one
// bulk copy of each array for the whole 16-byte units (where both lists
// are 16-byte aligned), which completes on barrier bar (thread 0 arrives on
// it, with or without bytes), the rest by every thread of the block (the
// caller synchronises).
template <typename T>
__device__ __forceinline__ void stage_overflow(const int32_t* oc, const T* ov,
                                               int lo, int hi, int32_t* s_oc,
                                               T* s_ov, uint32_t bar,
                                               bool bulk) {
  const int mid = bulk ? max(lo, hi & ~3) : lo;
  if (threadIdx.x == 0) {
    if (mid > lo) {
      const uint32_t n = (uint32_t)(mid - lo);
      mbar_expect_tx(bar, n * (uint32_t)(sizeof(int32_t) + sizeof(T)));
      bulk_copy_g2s(smem_u32(s_oc), oc + lo, n * sizeof(int32_t), bar);
      bulk_copy_g2s(smem_u32(s_ov), ov + lo, n * sizeof(T), bar);
    } else {
      mbar_arrive(bar);
    }
  }
  for (int e = mid + threadIdx.x; e < hi; e += blockDim.x) {
    s_oc[e - lo] = __ldg(oc + e);
    s_ov[e - lo] = __ldg(ov + e);
  }
}

// The step's cover, as a k-column launch stages it (kernels/bdia.py:
// step_cover): segments [seg_ptr[i], seg_ptr[i + 1]) of segs, rows of
// (x_lo, length, panel offset), for step i = part * nsteps + step; and
// each (block, slot) window's offset in its step's panel
struct Cover {
  const int32_t* seg_ptr;
  const int32_t* segs;
  const int32_t* xoff;
};

template <typename T, int KC>
__global__ void __launch_bounds__(max_threads(KC), min_blocks(KC))
bdia_spmv_xl_kernel(const T* __restrict__ vals,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ step_lo,
                    const int32_t* __restrict__ step_b0,
                    const T* __restrict__ x,
                    const int32_t* __restrict__ ovf_ptr,
                    const int32_t* __restrict__ ovf_cols,
                    const T* __restrict__ ovf_vals,
                    const uint8_t* __restrict__ mask,
                    const Cover cov, Update<T> upd, T* y,
                    int nblocks, int nslots, int block_rows, int row_pad,
                    int col_pad, int xpad_lo, int ovf_len, int gb, int nsteps,
                    int panel, int mask_bytes, int stage, int64_t xs_c,
                    int64_t ys_c) {
  constexpr int kRows = kRowBytes / sizeof(T);   // rows per thread and pass
  constexpr int kPasses = passes(KC, (int)sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);   // panel, overflow
  T* s_x = reinterpret_cast<T*>(smem + kBarrierBytes);
  int32_t* s_off = reinterpret_cast<int32_t*>(
      smem + kBarrierBytes + (size_t)KC * panel * sizeof(T));
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_off + gb * nslots);
  const size_t fixed = kBarrierBytes + (size_t)KC * panel * sizeof(T)
                       + (size_t)gb * nslots * (4 + mask_bytes);
  int32_t* s_oc = reinterpret_cast<int32_t*>(smem + (fixed + 15) / 16 * 16);
  T* s_ov = reinterpret_cast<T*>(s_oc + stage);

  const int step = blockIdx.x;
  const int p = blockIdx.y;
  const int64_t si = (int64_t)p * (nsteps + 1) + step;
  const int b0 = step_b0[si];
  const int nb = step_b0[si + 1] - b0;
  const T* xp = x + (int64_t)p * col_pad;   // column 0's part; column c at
                                            // xp + c * xs_c
  const int lo = step_lo[(int64_t)p * nsteps + step];
  const int nrows = nb * block_rows;
  const int row_first = b0 * block_rows;
  const int row_end = min(row_first + nrows, row_pad);

  // the part of each staged panel the bulk copies move: whole 16-byte
  // units of x, where every staged column's base is 16-byte aligned.  One
  // column's panel is [lo, lo + panel) of x; a k-column launch's are its
  // step's cover segments, packed (cov)
  const int pad4 = col_pad - col_pad % kAlign;
  bool aligned = true;
  for (int c = 0; c < KC; ++c) {
    aligned = aligned
        && (reinterpret_cast<uintptr_t>(xp + c * xs_c) % 16) == 0;
  }
  const int c_lo = max(lo, 0);
  const int c_hi = min(lo + panel, pad4);
  const int64_t sc = (int64_t)p * nsteps + step;
  const int cov0 = KC > 1 ? __ldg(cov.seg_ptr + sc) : 0;
  const int cov1 = KC > 1 ? __ldg(cov.seg_ptr + sc + 1) : 0;
  // segment q's x range [g_lo, g_hi), its panel offset, and the part
  // [b_lo, b_hi) the bulk copies move (empty at g_hi: the threads' all)
  auto segment = [&](int q, int& g_lo, int& g_hi, int& off, int& b_lo,
                     int& b_hi) {
    const int32_t* sg = cov.segs + 3 * (int64_t)q;
    g_lo = __ldg(sg);
    g_hi = g_lo + __ldg(sg + 1);
    off = __ldg(sg + 2);
    b_lo = max(g_lo, 0);
    b_hi = min(g_hi, pad4);
    if (!aligned || b_hi <= b_lo) {
      b_lo = b_hi = g_hi;
    }
  };
  uint32_t bulk_bytes = 0;   // one column's
  if constexpr (KC == 1) {
    bulk_bytes = aligned && c_hi > c_lo ? (c_hi - c_lo) * sizeof(T) : 0;
  } else {
    for (int q = cov0; q < cov1; ++q) {
      int g_lo, g_hi, off, b_lo, b_hi;
      segment(q, g_lo, g_hi, off, b_lo, b_hi);
      bulk_bytes += (uint32_t)(b_hi - b_lo) * sizeof(T);
    }
  }
  const bool bulk = bulk_bytes > 0;
  // the step's overflow span, its start rounded down to a 16-byte unit
  const int32_t* pp = ovf_ptr + (int64_t)p * (row_pad + 1);
  const int32_t* oc = ovf_cols + (int64_t)p * ovf_len;
  const T* ov = ovf_vals + (int64_t)p * ovf_len;
  const bool has_ovf = ovf_ptr != nullptr && row_first < row_end;
  const int e_lo = has_ovf ? __ldg(pp + row_first) & ~3 : 0;
  const int e_hi = has_ovf ? __ldg(pp + row_end) : 0;
  const bool ovf_bulk = (reinterpret_cast<uintptr_t>(oc) % 16) == 0
                        && (reinterpret_cast<uintptr_t>(ov) % 16) == 0;
  const uint32_t bar_x = smem_u32(bar), bar_o = smem_u32(bar + 1);
  if (threadIdx.x == 0) {
    mbar_init(bar_x, 1);
    mbar_init(bar_o, 1);
  }
  __syncthreads();
  if (bulk && threadIdx.x == 0) {
    mbar_expect_tx(bar_x, bulk_bytes * (uint32_t)KC);
    if constexpr (KC == 1) {
      bulk_copy_g2s(smem_u32(s_x + (c_lo - lo)), xp + c_lo, bulk_bytes,
                    bar_x);
    } else {
      for (int q = cov0; q < cov1; ++q) {
        int g_lo, g_hi, off, b_lo, b_hi;
        segment(q, g_lo, g_hi, off, b_lo, b_hi);
        if (b_hi > b_lo) {
          for (int c = 0; c < KC; ++c) {
            bulk_copy_g2s(
                smem_u32(s_x + (size_t)c * panel + off + (b_lo - g_lo)),
                xp + c * xs_c + b_lo, (uint32_t)(b_hi - b_lo) * sizeof(T),
                bar_x);
          }
        }
      }
    }
  }
  if (e_lo < e_hi) {   // the first chunk of the overflow, during the slots
    stage_overflow(oc, ov, e_lo, min(e_lo + stage, e_hi), s_oc, s_ov, bar_o,
                   ovf_bulk);
  }
  // the threads: window offsets, mask rows, and the panels outside the copy
  const int64_t blk0 = (int64_t)p * nblocks + b0;
  if constexpr (KC == 1) {
    const int32_t* st = starts + blk0 * nslots;
    for (int i = threadIdx.x; i < nb * nslots; i += blockDim.x) {
      s_off[i] = st[i] - xpad_lo - lo;
    }
  } else {
    const int32_t* st = cov.xoff + blk0 * nslots;
    for (int i = threadIdx.x; i < nb * nslots; i += blockDim.x) {
      s_off[i] = st[i];
    }
  }
  const uint8_t* mk = mask + blk0 * nslots * mask_bytes;
  for (int i = threadIdx.x; i < nb * nslots * mask_bytes; i += blockDim.x) {
    s_mask[i] = mk[i];
  }
  // the x entries [g_lo, g_hi) of column c at panel entry off: ours
  // where no bulk copy moves them, 0 outside [0, col_pad)
  auto fill = [&](int c, int g_lo, int g_hi, int off) {
    const T* xc = xp + c * xs_c;
    T* sx = s_x + (size_t)c * panel + off;
    for (int g = g_lo + (int)threadIdx.x; g < g_hi; g += blockDim.x) {
      sx[g - g_lo] = (g >= 0 && g < col_pad) ? xc[g] : T(0);
    }
  };
  if constexpr (KC == 1) {
    // panel entries [copy_lo, copy_hi) are the bulk copy's, the rest ours
    const int copy_lo = bulk ? c_lo - lo : panel;
    const int copy_hi = bulk ? c_hi - lo : panel;
    fill(0, lo, lo + copy_lo, 0);
    fill(0, lo + copy_hi, lo + panel, copy_hi);
  } else {
    for (int q = cov0; q < cov1; ++q) {
      int g_lo, g_hi, off, b_lo, b_hi;
      segment(q, g_lo, g_hi, off, b_lo, b_hi);
      for (int c = 0; c < KC; ++c) {
        fill(c, g_lo, b_lo, off);
        fill(c, b_hi, g_hi, off + (b_hi - g_lo));
      }
    }
  }
  __syncthreads();

  // x of column c at panel entry q, from the staged panels
  auto xq = [&](int c, int q) -> T { return s_x[(size_t)c * panel + q]; };

  // Slots.  Pass ps: warp w owns the 32 * kRows rows from (w + ps * warps)
  // * 32 * kRows of the step, one R-row block's (R is a multiple of 128),
  // its lane the rows lane, lane + 32, ...
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  bool waited = !bulk;
  T acc[KC][kPasses][kRows];
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        acc[c][ps][j] = T(0);
      }
    }
    const int base = (threadIdx.x / 32 + ps * warps) * 32 * kRows;
    if (base >= nrows || row_first + base >= row_pad) {
      continue;
    }
    const int k = base / block_rows;                 // block within the step
    const int r0 = base - k * block_rows + lane;     // row in the block, j = 0
    const T* v = vals + (blk0 + k) * nslots * (int64_t)block_rows + r0;
    const int32_t* off = s_off + k * nslots;
    // the warp's row groups are mask bits seg0 ... seg0 + kRows - 1, all in
    // one byte (seg0 is a multiple of kRows, kRows divides 8)
    const int seg0 = (base - k * block_rows) / kSegRows;
    const uint8_t* mrow = s_mask + k * nslots * mask_bytes + seg0 / 8;
    const int mshift = seg0 % 8;
    auto live = [&](int d) -> unsigned {
      return (unsigned)mrow[d * mask_bytes] >> mshift;
    };
    int d = 0;
    if (ps == 0) {
      // the first slots' values, loaded while the panel is on its way
      T pre[kPreSlots][kRows];
#pragma unroll
      for (int dd = 0; dd < kPreSlots; ++dd) {
        const unsigned m = dd < nslots ? live(dd) : 0u;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          pre[dd][j] = (m >> j) & 1u
              ? __ldcs(v + (int64_t)dd * block_rows + 32 * j) : T(0);
        }
      }
      if (!waited) {
        mbar_wait(bar_x, 0);
        waited = true;
      }
#pragma unroll
      for (int dd = 0; dd < kPreSlots; ++dd) {
        if (dd < nslots) {
#pragma unroll
          for (int c = 0; c < KC; ++c) {
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              acc[c][ps][j] += pre[dd][j] * xq(c, off[dd] + r0 + 32 * j);
            }
          }
        }
      }
      d = kPreSlots;
    }
#pragma unroll 4
    for (; d < nslots; ++d) {
      const unsigned m = live(d);
      const T* vd = v + (int64_t)d * block_rows;
      T vv[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        vv[j] = (m >> j) & 1u ? __ldcs(vd + 32 * j) : T(0);
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          acc[c][ps][j] += vv[j] * xq(c, off[d] + r0 + 32 * j);
        }
      }
    }
  }
  if (!waited) {
    mbar_wait(bar_x, 0);   // the panel: the overflow's x, and no copy left
  }

  // The overflow, chunk by chunk, each row's entries in list order
  if (e_lo < e_hi) {
    int eb[kPasses][kRows], ee[kPasses][kRows];
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int base = (threadIdx.x / 32 + ps * warps) * 32 * kRows;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int row = row_first + base + lane + 32 * j;
        const bool mine = base < nrows && row < row_end;
        eb[ps][j] = mine ? __ldg(pp + row) : 0;
        ee[ps][j] = mine ? __ldg(pp + row + 1) : 0;
      }
    }
    for (int c0 = e_lo, phase = 0; c0 < e_hi; c0 += stage, phase ^= 1) {
      const int c1 = min(c0 + stage, e_hi);
      if (c0 != e_lo) {
        __syncthreads();   // every thread is done with the last chunk
        if (threadIdx.x == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        }
        stage_overflow(oc, ov, c0, c1, s_oc, s_ov, bar_o, ovf_bulk);
      }
      __syncthreads();     // the threads' part of the chunk is in
      mbar_wait(bar_o, phase);
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int q1 = min(ee[ps][j], c1);
          for (int e = max(eb[ps][j], c0); e < q1; ++e) {
            const T ve = s_ov[e - c0];
            const int g = s_oc[e - c0];
            // one column's panel spans x around the step: the entry is
            // there but for a column far off the band.  A k-column
            // launch's list holds the entry's panel offset where its
            // step's cover holds it, else -(column + 1)
            // (kernels/bdia.py: cover_overflow)
            const int q = KC == 1 ? g - lo : g;
            const bool in = q >= 0 && (KC > 1 || q < panel);
            const int gx = KC == 1 ? g : -g - 1;
#pragma unroll
            for (int c = 0; c < KC; ++c) {
              const T xe = in ? xq(c, q) : __ldg(xp + c * xs_c + gx);
              acc[c][ps][j] += ve * xe;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps) {
    const int base = (threadIdx.x / 32 + ps * warps) * 32 * kRows;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = row_first + base + lane + 32 * j;
      if (base < nrows && row < row_pad) {
        const int64_t i = (int64_t)p * row_pad + row;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          y[c * ys_c + i] = upd(acc[c][ps][j], i, c * ys_c);
        }
      }
    }
  }
}

template <typename T, int KC>
int launch_k(const void* vals, const void* starts, const void* step_lo,
             const void* step_b0, const void* x, const void* ovf_ptr,
             const void* ovf_cols, const void* ovf_vals, const void* mask,
             const Cover& cov, const Update<T>& upd, void* y, int nparts,
             int nblocks,
             int nslots, int block_rows, int row_pad, int col_pad,
             int xpad_lo, int ovf_len, int gb, int nsteps, int panel,
             int stage, int64_t xs_c, int64_t ys_c,
             void* stream) {
  constexpr int kRows = kRowBytes / (int)sizeof(T);
  constexpr int kPasses = passes(KC, (int)sizeof(T));
  const int threads = min(max_threads(KC),
                          (gb * block_rows / kRows + 31) / 32 * 32);
  if (block_rows % (kSegRows * kRows)
      || gb * block_rows > threads * kRows * kPasses
      || stage % 4 || (ovf_ptr != nullptr && stage < 4) || step_b0 == nullptr
      || mask == nullptr || panel % kAlign
      || (KC > 1 && (cov.seg_ptr == nullptr || cov.segs == nullptr
                     || cov.xoff == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int mask_bytes = (block_rows / kSegRows + 7) / 8;
  const size_t fixed = kBarrierBytes + (size_t)KC * panel * sizeof(T)
                       + (size_t)gb * nslots * (sizeof(int32_t) + mask_bytes);
  const size_t smem = (fixed + 15) / 16 * 16
                      + (size_t)stage * (sizeof(int32_t) + sizeof(T));
  // opt in to the shared memory above the default 48 KB, once per device
  static size_t opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return (int)err;
  }
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > opted[dev])) {
    err = cudaFuncSetAttribute(bdia_spmv_xl_kernel<T, KC>,
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
  bdia_spmv_xl_kernel<T, KC><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)starts, (const int32_t*)step_lo,
      (const int32_t*)step_b0, (const T*)x, (const int32_t*)ovf_ptr,
      (const int32_t*)ovf_cols, (const T*)ovf_vals, (const uint8_t*)mask,
      cov, upd, (T*)y, nblocks, nslots, block_rows, row_pad, col_pad, xpad_lo,
      ovf_len, gb, nsteps, panel, mask_bytes, stage, xs_c, ys_c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* starts, const void* step_lo,
           const void* step_b0, const void* x, const void* ovf_ptr,
           const void* ovf_cols, const void* ovf_vals, const void* mask,
           const void* seg_ptr, const void* segs, const void* xoff,
           const void* b, const void* s, const void* c, void* y, double w,
           int nparts, int nblocks, int nslots, int block_rows, int row_pad,
           int col_pad, int xpad_lo, int ovf_len, int gb, int nsteps,
           int panel, int stage, int ncols, int64_t xs_c,
           int64_t ys_c, void* stream) {
  const Update<T> upd{(const T*)b, (const T*)s, (const T*)c, (T)w};
  const Cover cov{(const int32_t*)seg_ptr, (const int32_t*)segs,
                  (const int32_t*)xoff};
#define XL_COLS(KC_)                                                        \
  case KC_:                                                                 \
    return launch_k<T, KC_>(vals, starts, step_lo, step_b0, x, ovf_ptr,     \
                            ovf_cols, ovf_vals, mask, cov, upd, y, nparts,  \
                            nblocks, nslots, block_rows, row_pad, col_pad,  \
                            xpad_lo, ovf_len, gb, nsteps, panel, stage,     \
                            xs_c, ys_c, stream);
  switch (ncols) {
    XL_COLS(1)
    XL_COLS(2)
    XL_COLS(3)
    XL_COLS(4)
    XL_COLS(5)
    XL_COLS(6)
    XL_COLS(7)
    XL_COLS(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef XL_COLS
}

}  // namespace

extern "C" {

// ncols: the columns k (1 to 8); column j of x at x + j * xs_c, of y, b,
// c at j * ys_c (s one vector for all columns); seg_ptr, segs, xoff: the
// steps' cover for k > 1 (null for one column); the rest as K4's arguments
// and the step plan
#define XL_ENTRY(NAME, T)                                                    \
  int NAME(const void* vals, const void* starts, const void* step_lo,       \
           const void* step_b0, const void* x, const void* ovf_ptr,         \
           const void* ovf_cols, const void* ovf_vals, const void* mask,    \
           const void* seg_ptr, const void* segs, const void* xoff,         \
           const void* b, const void* s, const void* c, void* y, double w,  \
           int nparts, int nblocks, int nslots, int block_rows,             \
           int row_pad, int col_pad, int xpad_lo, int ovf_len, int gb,      \
           int nsteps, int panel, int stage, int ncols, int64_t xs_c,       \
           int64_t ys_c, void* stream) {                                    \
    return launch<T>(vals, starts, step_lo, step_b0, x, ovf_ptr, ovf_cols,  \
                     ovf_vals, mask, seg_ptr, segs, xoff, b, s, c, y, w,    \
                     nparts, nblocks, nslots,                               \
                     block_rows, row_pad, col_pad, xpad_lo, ovf_len, gb,    \
                     nsteps, panel, stage, ncols, xs_c, ys_c, stream);      \
  }

XL_ENTRY(bdia_spmv_xl_f32, float)
XL_ENTRY(bdia_spmv_xl_f64, double)

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
