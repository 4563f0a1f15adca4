// ELL sparse matrix-vector product for Hopper (sm_90a), K2: its entry
// points on bfloat16 values (the smoother twin; the kernels and their
// design: csrc/ell_spmv.cuh).

#include "ell_spmv.cuh"

ELL_ENTRY(ell_spmv_bf16_f32, float, uint16_t)
ELL_ENTRY(ell_spmv_bf16_f64, double, uint16_t)

extern "C" const char* tpusolve_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
