// The thermal update on NVIDIA Hopper (sm_90a): ops/thermal.py's
// update_temperature as one kernel launch, the nsub exponential-Euler
// substeps of a cell in registers, a cell a thread. The device code and its
// design are in thermal.cuh.

#include "thermal.cuh"

using namespace thermal;

extern "C" {

// The update over n cells on `stream`: temp, ndens, xh and heat in, the
// new temperature into `out`; dt from `dt_ptr` (a 0-dim tensor on the
// device, dt_kind 1 float32, 2 float64) or `dt_value` (dt_kind 0); nsub
// substeps; `params` the 15 doubles of TConst. Returns the cudaError_t of
// the launch.
#define THERMAL_ENTRY(NAME, TYPE)                                              \
  int NAME(const void* dt_ptr, int dt_kind, double dt_value,                  \
           const void* temp, const void* ndens, const void* xh,               \
           const void* heat, void* out, long long n, int nsub,               \
           const double* params, void* stream) {                              \
    using P = const TYPE*;                                                     \
    TArgs<TYPE> a{static_cast<P>(temp), static_cast<P>(ndens),                 \
                  static_cast<P>(xh),   static_cast<P>(heat),                  \
                  static_cast<TYPE*>(out), n, nsub,                            \
                  Dt{dt_ptr, dt_kind, dt_value},                               \
                  t_const<TYPE>(params, nsub)};                                \
    return dispatch(a, CudaLaunch{static_cast<cudaStream_t>(stream)});        \
  }

THERMAL_ENTRY(thermal_update_f32, float)
THERMAL_ENTRY(thermal_update_f64, double)

const char* thermal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
