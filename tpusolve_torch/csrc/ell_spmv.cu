// ELL sparse matrix-vector product for Hopper (sm_90a), K2: its entry
// points on values of x's type, and the pack of its k-column form (the
// kernels and their design: csrc/ell_spmv.cuh).

#include "ell_spmv.cuh"

ELL_ENTRY(ell_spmv_f32, float, float)
ELL_ENTRY(ell_spmv_f64, double, double)

// x (ncols, n), column j at x + j * xs_c, packed into xp (n, ncols) for
// the k-column form; 2 <= ncols <= 8
extern "C" int ell_pack_f32(const void* x, int64_t xs_c, int64_t n,
                            int ncols, void* xp, void* stream) {
  return pack<float>(x, xs_c, n, ncols, xp, stream);
}
extern "C" int ell_pack_f64(const void* x, int64_t xs_c, int64_t n,
                            int ncols, void* xp, void* stream) {
  return pack<double>(x, xs_c, n, ncols, xp, stream);
}

extern "C" const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
