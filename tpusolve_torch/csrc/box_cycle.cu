// The structured V-cycle's box transfers carried inside K1's launches, for
// Hopper (sm_90a): K3 redesigned.
//
// Replaces, on the cycle, the pairs of launches K1 -> K3 and K3 -> K1
// around each structured transition: tpusolve/amg/structured.py:129
// _restrict_local after tpusolve/matrix/spmv.py:79 dia_spmv_local's
// residual, and :122 _prolong_local (with the correction's add) before the
// first post-smoothing sweep (XLA fusions in tpusolve, not Pallas kernels).
// On a fine box (nz, ny, nx) of each part, x fastest, and its coarse box
// (nz/2, ny/2, nx/2), with A the level's box-DIA operator (csrc/dia_spmv.cu):
//
//   * box_restrict_residual:  rc = P^T (b - A x);
//   * box_prolong_update:     x' = x + P ec, then
//                             y = [x'] + w s (.) (b - A x'),
//     the bracket present for a Jacobi sweep (c = x') and absent for
//     Chebyshev's first step; x' is also written out when asked.
//
// Each result equals the pair's bit for bit: every fine residual or update
// is K1's (its row sum over the same G contiguous chunks of slots, the
// partial sums added in chunk order, and its epilogue), every transfer
// K3's (z, then y, then x, each step rounded), from csrc/box_cycle.cuh.
// No atomics: the same bits in every run.
//
// What bounds them: A's planes, nearly all of the bytes, and a launch's
// latency on the small boxes.  The design, the same for both: one
// cooperative launch in two phases with a grid barrier between them
// (cooperative_groups' grid sync; every block is resident, so none waits
// on one that is not):
//   * restriction: first K1's residual in K1's own blocks (RB rows by G
//     threads a row, consecutive threads on consecutive rows), the grid's
//     blocks walking K1's blocks in turn, into a scratch vector; then K3's
//     restriction, each block over one contiguous run of coarse cells: on
//     the large boxes (G <= 2) a thread a cell, as K3; on the small ones
//     four lanes a cell (one x cell of its window each, eight cells a
//     warp), the x step gathered by shuffles, which keeps more loads in
//     flight there (each layout measured the faster on its side);
//   * prolongation: first x' = x + P ec for every fine row (into xnew, the
//     caller's or a scratch vector); then K1's update in K1's blocks.
// On the large boxes (G <= 2 threads a row, f32) a thread sums two rows at
// once, their loads issued together, at 64 registers; elsewhere one row,
// at K1's occupancy in f32.  A plane stack larger than kStreamBytes is
// loaded as streamed data, so the vector between the phases stays in L2.
// A is read once.  That vector (the fine residual, x') crosses L2 as it
// crossed device memory between the pair's launches; the gain is the
// launch.  Kernels that kept it in shared memory were measured slower at
// most transitions (PERF.md): a restriction tile's window reaches one fine
// row past the tile, so its edge rows were computed twice or traded
// between the blocks of a cluster through distributed shared memory
// (1.7-2.5 times the pair at the best tile and cluster), and a
// prolongation tile that formed x' and its halo in shared memory was 1-3 %
// faster than the pair at two transitions and 7-10 % slower at three.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (tpusolve_torch/kernels/build.py).  Each entry point launches
// on the caller's stream, does not synchronise, and returns the value of
// cudaGetLastError() after the launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "box_cycle.cuh"

namespace cg = cooperative_groups;

namespace {

using box_cycle::add_rn;
using box_cycle::epilogue;
using box_cycle::kMaxSlots;
using box_cycle::Plan;
using box_cycle::row_partials;
using box_cycle::Slots;

// rows a thread sums at once, and blocks an SM must hold (so registers a
// thread), of the cooperative kernels at K1's G threads a row
template <typename T, int G>
struct Shape {
  static constexpr int R = sizeof(T) == 4 && G <= 2 ? 2 : 1;
  static constexpr int kBlocks =
      65536 / (Plan<G>::kThreads * (R == 2 ? 64 : (sizeof(T) == 4 ? 40 : 80)));
};

// K1's row sums of the R chunks of RB rows of one virtual block, `vb` of
// each part's nb (R * RB rows each, K1's G threads a row): the part p, this
// thread's rows i[k] of it, and their sums (on group 0 only, meaningful
// where valid[k]); xat(o) loads x at flat index o; `stream` as in
// row_partials
template <typename T, int G, int R, typename V, typename XAt>
__device__ __forceinline__ void k1_block_rows(const V* __restrict__ vals,
                                              const Slots& slots, int nslots,
                                              int nz, int ny, int nx, int nb,
                                              int vb, bool stream, int* p,
                                              int (&i)[R], bool (&valid)[R],
                                              T (&acc)[R], XAt xat) {
  constexpr int RB = Plan<G>::RB;
  const int box = nz * ny * nx;
  const int r = threadIdx.x % RB, g = threadIdx.x / RB;
  *p = vb / nb;
  int iz[R], iy[R], ix[R];
  int64_t o[R];
  const V* vp[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    i[k] = ((vb - *p * nb) * R + k) * RB + r;
    valid[k] = i[k] < box;
    ix[k] = iy[k] = iz[k] = 0;
    if (valid[k]) {
      ix[k] = i[k] % nx;
      const int zy = i[k] / nx;
      iy[k] = zy % ny;
      iz[k] = zy / ny;
    }
    o[k] = (int64_t)*p * box + i[k];
    vp[k] = vals + (int64_t)*p * nslots * box + i[k];
  }
  const int chunk = (nslots + G - 1) / G;
  const int d_lo = g * chunk, d_hi = min(nslots, d_lo + chunk);
  row_partials<T, R>(acc, vp, box, slots, d_lo, d_hi, valid, iz, iy, ix, nz,
                     ny, nx,
                     [&](int k, int d) { return xat(o[k] + slots.d[d][3]); },
                     stream);
  if constexpr (G > 1) {
    __shared__ T part[G][R][RB];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      part[g][k][r] = acc[k];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
#pragma unroll
        for (int q = 1; q < G; ++q) {
          acc[k] += part[q][k][r];
        }
      }
    }
    __syncthreads();
  }
}

constexpr int kCells = 2;   // coarse cells a lane restricts at once

// rc = P^T (b - A x), rr the fine residual's scratch; (nz, ny, nx) is the
// fine box.  Launched cooperatively
template <typename T, int G>
__global__ void __launch_bounds__(Plan<G>::kThreads, Shape<T, G>::kBlocks)
restrict_residual_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                         const T* __restrict__ b, T* rr, T* __restrict__ rc,
                         const __grid_constant__ Slots slots, int nslots,
                         int nparts, int nz, int ny, int nx, int stream) {
  constexpr int RB = Plan<G>::RB, R = Shape<T, G>::R;
  const int box = nz * ny * nx;
  const int nb = (box + R * RB - 1) / (R * RB);
  for (int vb = blockIdx.x; vb < nb * nparts; vb += gridDim.x) {
    int p, i[R];
    bool valid[R];
    T acc[R];
    k1_block_rows<T, G, R>(vals, slots, nslots, nz, ny, nx, nb, vb,
                           stream != 0, &p, i, valid, acc,
                           [&](int64_t o) { return __ldg(x + o); });
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (threadIdx.x < RB && valid[k]) {
        const int64_t o = (int64_t)p * box + i[k];
        rr[o] = epilogue(acc[k], true, b[o], false, T(0), false, T(0), T(1));
      }
    }
  }
  cg::this_grid().sync();
  // a block walks one contiguous run of the coarse cells, so that the fine
  // rows of one coarse row's windows are still in L1 for the next row's
  const int mz = nz / 2, my = ny / 2, mx = nx / 2;
  const int coarse = mz * my * mx, cells = nparts * coarse;
  if constexpr (G <= 2) {
    // the large boxes: a thread a coarse cell, K3's layout (measured the
    // faster one there)
    const int per = (cells + gridDim.x - 1) / gridDim.x;
    const int c1 = min(cells, (int)(blockIdx.x + 1) * per);
    for (int c = blockIdx.x * per + threadIdx.x; c < c1; c += blockDim.x) {
      const int p = c / coarse, i = c - p * coarse;
      const int cx = i % mx, zy = i / mx;
      const int cy = zy % my, cz = zy / my;
      int zs[4], ys[4], xs[4];
      box_cycle::window(cz, mz, zs);
      box_cycle::window(cy, my, ys);
      box_cycle::window(cx, mx, xs);
      // written in this launch: plain loads, not the read-only path
      const T* r = rr + (int64_t)p * box;
      rc[c] = box_cycle::restrict_point<T>([&](int m, int j, int q) {
        return r[(zs[m] * ny + ys[j]) * nx + xs[q]];
      });
    }
    return;
  }
  // the small boxes: eight coarse cells a warp, four lanes a cell (more
  // loads in flight): lane 8k + c takes cell c's z and y steps at its
  // window's k-th x cell, lane c then the x step (restrict_point's order);
  // each lane takes kCells cells at once, their loads issued together
  const int lane = threadIdx.x % 32, c8 = lane % 8, k = lane / 8;
  const int nw = blockDim.x / 32;
  const int tasks = (cells + 7) / 8;               // eight cells each
  const int per = (tasks + gridDim.x - 1) / gridDim.x;
  const int t0 = blockIdx.x * per, t1 = min(tasks, t0 + per);
  for (int t = t0 + threadIdx.x / 32; t < t1; t += kCells * nw) {
    T v[kCells];
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      const int c = 8 * (t + q * nw) + c8;
      v[q] = T(0);
      if (t + q * nw < t1 && c < cells) {
        const int p = c / coarse, i = c - p * coarse;
        const int cx = i % mx, zy = i / mx;
        const int cy = zy % my, cz = zy / my;
        int zs[4], ys[4], xs[4];
        box_cycle::window(cz, mz, zs);
        box_cycle::window(cy, my, ys);
        box_cycle::window(cx, mx, xs);
        const T* r = rr + (int64_t)p * box;
        v[q] = box_cycle::restrict_zy<T>(
            [&](int m, int j, int x4) {
              return r[(zs[m] * ny + ys[j]) * nx + xs[x4]];
            },
            k);
      }
    }
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      const int c = 8 * (t + q * nw) + c8;
      const T v0 = __shfl_sync(0xffffffffu, v[q], c8);
      const T v1 = __shfl_sync(0xffffffffu, v[q], c8 + 8);
      const T v2 = __shfl_sync(0xffffffffu, v[q], c8 + 16);
      const T v3 = __shfl_sync(0xffffffffu, v[q], c8 + 24);
      if (k == 0 && t + q * nw < t1 && c < cells) {
        rc[c] = box_cycle::down(v0, v1, v2, v3);
      }
    }
  }
}

// x' = x + P ec into xn, then y = [x'] + w s (.) (b - A x'); (nz, ny, nx)
// is the fine box.  Launched cooperatively
template <typename T, typename V, int G>
__global__ void __launch_bounds__(Plan<G>::kThreads, Shape<T, G>::kBlocks)
prolong_update_kernel(const V* __restrict__ vals, const T* __restrict__ ec,
                      const T* __restrict__ x, const T* __restrict__ b,
                      const T* __restrict__ s, T* y, T* xn,
                      const __grid_constant__ Slots slots, int nslots,
                      int nparts, int nz, int ny, int nx, T w,
                      int c_is_xnew, int stream) {
  constexpr int RB = Plan<G>::RB, R = Shape<T, G>::R;
  const int box = nz * ny * nx;
  const int mz = nz / 2, my = ny / 2, mx = nx / 2;
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < nparts * box;
       o += gridDim.x * blockDim.x) {
    const int p = o / box, i = o - p * box;
    const int ix = i % nx, zy = i / nx;
    const int iy = zy % ny, iz = zy / ny;
    const T* a = ec + (int64_t)p * mz * my * mx;
    xn[o] = add_rn(__ldg(x + o), box_cycle::prolong_point<T>(
        [&](int zc, int yc, int xc) {
          return __ldg(a + (zc * my + yc) * mx + xc);
        },
        iz, iy, ix, mz, my, mx));
  }
  cg::this_grid().sync();
  const int nb = (box + R * RB - 1) / (R * RB);
  for (int vb = blockIdx.x; vb < nb * nparts; vb += gridDim.x) {
    int p, i[R];
    bool valid[R];
    T acc[R];
    // x' was written in this launch: plain loads, not the read-only path
    k1_block_rows<T, G, R>(vals, slots, nslots, nz, ny, nx, nb, vb,
                           stream != 0, &p, i, valid, acc,
                           [&](int64_t o) { return xn[o]; });
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (threadIdx.x < RB && valid[k]) {
        const int64_t o = (int64_t)p * box + i[k];
        y[o] = epilogue(acc[k], true, b[o], s != nullptr,
                        s != nullptr ? s[o] : T(0), c_is_xnew != 0, xn[o],
                        w);
      }
    }
  }
}

// the slot table of a fine box
bool make_slots(const int* offs, int nslots, int ny, int nx, Slots* slots) {
  if (nslots < 0 || nslots > kMaxSlots) {
    return false;
  }
  for (int d = 0; d < nslots; ++d) {
    const int dz = offs[3 * d], dy = offs[3 * d + 1], dx = offs[3 * d + 2];
    slots->d[d][0] = dz;
    slots->d[d][1] = dy;
    slots->d[d][2] = dx;
    slots->d[d][3] = (dz * ny + dy) * nx + dx;
  }
  return true;
}

bool bad_box(int nparts, int nz, int ny, int nx) {
  return nparts <= 0 || nz < 2 || ny < 2 || nx < 2 || nz % 2 || ny % 2 ||
         nx % 2 || (int64_t)nparts * nz * ny * nx >= ((int64_t)1 << 31);
}

constexpr int kDevices = 64;   // devices whose resident blocks are kept

// launches `kern` cooperatively on as many blocks of `threads` as the card
// holds at once (at most `want`); `resident` keeps that count, a device
// each, looked up at the kernel's first launch there
template <typename K>
cudaError_t launch_grid(K kern, int threads, int64_t want, void** args,
                        int* resident, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= kDevices) {
    return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  }
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      0);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess || per_sm * sms <= 0) {
      return e != cudaSuccess ? e : cudaErrorCooperativeLaunchTooLarge;
    }
    resident[dev] = per_sm * sms;
  }
  const unsigned blocks =
      (unsigned)(want < resident[dev] ? want : resident[dev]);
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                  dim3(threads), args, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// K1's virtual blocks of a box at G threads a row
template <typename T, int G>
int64_t virtual_blocks(int nparts, int nz, int ny, int nx) {
  constexpr int rows = Shape<T, G>::R * Plan<G>::RB;
  return ((int64_t)nz * ny * nx + rows - 1) / rows * nparts;
}

// planes of more bytes than this stream through L2 (of 50 MB), so that the
// vector between the phases stays there for the second
constexpr int64_t kStreamBytes = 32ll << 20;

template <typename V>
int streams(int nslots, int nparts, int nz, int ny, int nx) {
  return (int64_t)nslots * nparts * nz * ny * nx * (int64_t)sizeof(V) >
         kStreamBytes;
}

template <typename T, int G>
cudaError_t launch_restrict(const T* vals, const Slots& slots, int nslots,
                            const T* x, const T* b, T* rr, T* rc, int nparts,
                            int nz, int ny, int nx, cudaStream_t stream) {
  int streamed = streams<T>(nslots, nparts, nz, ny, nx);
  void* args[] = {(void*)&vals,   (void*)&x,      (void*)&b,
                  (void*)&rr,     (void*)&rc,     (void*)&slots,
                  (void*)&nslots, (void*)&nparts, (void*)&nz,
                  (void*)&ny,     (void*)&nx,     (void*)&streamed};
  static int resident[kDevices] = {0};
  return launch_grid(restrict_residual_kernel<T, G>, Plan<G>::kThreads,
                     virtual_blocks<T, G>(nparts, nz, ny, nx), args,
                     resident, stream);
}

template <typename T, typename V, int G>
cudaError_t launch_prolong(const V* vals, const Slots& slots, int nslots,
                           const T* ec, const T* x, const T* b, const T* s,
                           T* y, T* xnew, int nparts, int nz, int ny, int nx,
                           T w, int c_is_xnew, cudaStream_t stream) {
  int streamed = streams<V>(nslots, nparts, nz, ny, nx);
  void* args[] = {(void*)&vals,   (void*)&ec,    (void*)&x,
                  (void*)&b,      (void*)&s,     (void*)&y,
                  (void*)&xnew,   (void*)&slots, (void*)&nslots,
                  (void*)&nparts, (void*)&nz,    (void*)&ny,
                  (void*)&nx,     (void*)&w,     (void*)&c_is_xnew,
                  (void*)&streamed};
  static int resident[kDevices] = {0};
  return launch_grid(prolong_update_kernel<T, V, G>, Plan<G>::kThreads,
                     virtual_blocks<T, G>(nparts, nz, ny, nx), args,
                     resident, stream);
}

#define BOX_CYCLE_SWITCH(G_, CALL)                          \
  switch (G_) {                                             \
    case 1: { constexpr int kG = 1; return (int)(CALL); }   \
    case 2: { constexpr int kG = 2; return (int)(CALL); }   \
    case 4: { constexpr int kG = 4; return (int)(CALL); }   \
    case 8: { constexpr int kG = 8; return (int)(CALL); }   \
    case 16: { constexpr int kG = 16; return (int)(CALL); } \
    default: return (int)cudaErrorInvalidValue;            \
  }

template <typename T>
int restrict_residual(const void* vals, const int* offs, int nslots,
                      const void* x, const void* b, void* rr, void* rc,
                      int nparts, int nz, int ny, int nx, int groups,
                      void* stream) {
  Slots slots;
  if (bad_box(nparts, nz, ny, nx) ||
      !make_slots(offs, nslots, ny, nx, &slots)) {
    return (int)cudaErrorInvalidValue;
  }
  BOX_CYCLE_SWITCH(groups, (launch_restrict<T, kG>(
      (const T*)vals, slots, nslots, (const T*)x, (const T*)b, (T*)rr,
      (T*)rc, nparts, nz, ny, nx, (cudaStream_t)stream)))
}

template <typename T, typename V>
int prolong_update(const void* vals, const int* offs, int nslots,
                   const void* ec, const void* x, const void* b,
                   const void* s, void* y, void* xnew, int nparts, int nz,
                   int ny, int nx, int groups, double w, int c_is_xnew,
                   void* stream) {
  Slots slots;
  if (bad_box(nparts, nz, ny, nx) || xnew == nullptr ||
      !make_slots(offs, nslots, ny, nx, &slots)) {
    return (int)cudaErrorInvalidValue;
  }
  BOX_CYCLE_SWITCH(groups, (launch_prolong<T, V, kG>(
      (const V*)vals, slots, nslots, (const T*)ec, (const T*)x, (const T*)b,
      (const T*)s, (T*)y, (T*)xnew, nparts, nz, ny, nx, (T)w, c_is_xnew,
      (cudaStream_t)stream)))
}

}  // namespace

extern "C" {

// (nz, ny, nx) is the fine box in every entry point; offs the D slot
// triples of A; groups K1's G threads a row (1, 2, 4, 8, 16).
// rc = P^T (b - A x); rr, of x's shape, takes the fine residual
int box_restrict_residual_f32(const void* vals, const int* offs, int nslots,
                              const void* x, const void* b, void* rr,
                              void* rc, int nparts, int nz, int ny, int nx,
                              int groups, void* stream) {
  return restrict_residual<float>(vals, offs, nslots, x, b, rr, rc, nparts,
                                  nz, ny, nx, groups, stream);
}

int box_restrict_residual_f64(const void* vals, const int* offs, int nslots,
                              const void* x, const void* b, void* rr,
                              void* rc, int nparts, int nz, int ny, int nx,
                              int groups, void* stream) {
  return restrict_residual<double>(vals, offs, nslots, x, b, rr, rc, nparts,
                                   nz, ny, nx, groups, stream);
}

// y = [x'] + w s (.) (b - A x') for x' = x + P ec (c = x' when c_is_xnew;
// s may be null); xnew, of x's shape, takes x'
int box_prolong_update_f32(const void* vals, const int* offs, int nslots,
                           const void* ec, const void* x, const void* b,
                           const void* s, void* y, void* xnew, int nparts,
                           int nz, int ny, int nx, int groups, double w,
                           int c_is_xnew, void* stream) {
  return prolong_update<float, float>(vals, offs, nslots, ec, x, b, s, y,
                                      xnew, nparts, nz, ny, nx, groups, w,
                                      c_is_xnew, stream);
}

int box_prolong_update_f64(const void* vals, const int* offs, int nslots,
                           const void* ec, const void* x, const void* b,
                           const void* s, void* y, void* xnew, int nparts,
                           int nz, int ny, int nx, int groups, double w,
                           int c_is_xnew, void* stream) {
  return prolong_update<double, double>(vals, offs, nslots, ec, x, b, s, y,
                                        xnew, nparts, nz, ny, nx, groups, w,
                                        c_is_xnew, stream);
}

// the same on bf16 planes (their bits; the smoother twin): x' = x + P ec,
// then y = [x'] + w s (.) (b - A_relax x'), A_relax's values widened
// exactly to x's type
int box_prolong_update_bf16_f32(const void* vals, const int* offs,
                                int nslots, const void* ec, const void* x,
                                const void* b, const void* s, void* y,
                                void* xnew, int nparts, int nz, int ny,
                                int nx, int groups, double w, int c_is_xnew,
                                void* stream) {
  return prolong_update<float, uint16_t>(vals, offs, nslots, ec, x, b, s, y,
                                         xnew, nparts, nz, ny, nx, groups, w,
                                         c_is_xnew, stream);
}

int box_prolong_update_bf16_f64(const void* vals, const int* offs,
                                int nslots, const void* ec, const void* x,
                                const void* b, const void* s, void* y,
                                void* xnew, int nparts, int nz, int ny,
                                int nx, int groups, double w, int c_is_xnew,
                                void* stream) {
  return prolong_update<double, uint16_t>(vals, offs, nslots, ec, x, b, s,
                                          y, xnew, nparts, nz, ny, nx, groups,
                                          w, c_is_xnew, stream);
}

const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
