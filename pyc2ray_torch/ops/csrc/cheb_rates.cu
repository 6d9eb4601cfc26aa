// The dense spectral-bin rate pass of the unfused sweep modes for NVIDIA
// Hopper (sm_90a): one call per batch. The kernel, what it replaces, its
// design and its bound are in cheb_rates.cuh. Plain version:
// pyc2ray_torch/ops/cheb_rates.py::rates_dense_ref.

#include "cheb_rates.cuh"

extern "C" {

// The pass over B boxes on `stream` at the n_valid rated cells `cells` of
// the subbox: Gamma into `phi` and, where `heat` and `bins_wh` are set, the
// photoheating rate into `heat`, both zeroed by the caller. dr, sig and sdr3
// (S* / dr^3) are rounded to the element type here, as the plain version
// rounds them. Returns the cudaError_t of the launch.
#define RATES_DENSE_ENTRY(SFX, T)                                             \
  int rates_dense_##SFX(const void* cd, const void* nhi, const void* rt,     \
                        const int* cells, const void* flux,                  \
                        const void* bins_s, const void* bins_w,              \
                        const void* bins_wh, void* phi, void* heat, int B,   \
                        int E, int Dc, int Ds, int rb0, int n_valid,         \
                        double dr, double sig, double sdr3, void* stream) {  \
    using P = const T*;                                                      \
    return cheb::launch_rates_dense<T>(                                      \
        cheb::DenseRates<T>{(P)cd, (P)nhi, (P)rt, cells, (P)flux, (P)bins_s,  \
                            (P)bins_w, (P)bins_wh, static_cast<T*>(phi),      \
                            static_cast<T*>(heat), B, E, Dc, Ds, rb0,         \
                            n_valid, static_cast<T>(dr),                      \
                            static_cast<T>(sig), static_cast<T>(sdr3)},       \
        static_cast<cudaStream_t>(stream));                                   \
  }

RATES_DENSE_ENTRY(f32, float)
RATES_DENSE_ENTRY(f64, double)

const char* cheb_rates_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
