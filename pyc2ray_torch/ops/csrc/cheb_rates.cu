// The dense spectral-bin rate passes for NVIDIA Hopper (sm_90a), one call
// per batch: the unfused sweep modes' (rates_dense: the kernel, what it
// replaces, its design and its bound are in cheb_rates.cuh) and the helium
// engine's three-species pass (rates_he, cheb_rates_he.cuh). Plain
// versions: pyc2ray_torch/ops/cheb_rates.py::rates_dense_ref and
// rates_he_ref.

#include "cheb_rates.cuh"
#include "cheb_rates_he.cuh"

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

// The helium pass over B boxes on `stream` at the n_valid rated cells
// `cells` of the subbox: the three species' coldensh_out boxes cd0..cd2 and
// absorber boxes n0..n2 (HI, HeI, HeII) in, G_HI, G_HeI, G_HeII into
// out0..out2 and, where `out3` is set, the heat per HI atom into out3, all
// zeroed by the caller; the bins by band as ops/cheb_rates.py::he_bands
// packs them, the records `rec` on the card and their header `bands`
// (kHeHead ints) on the host. dr and sdr3 (S* / dr^3) are rounded to the
// element type here, as the plain version rounds them. Returns the
// cudaError_t of the launch.
#define RATES_HE_ENTRY(SFX, T)                                                \
  int rates_he_##SFX(const void* cd0, const void* cd1, const void* cd2,       \
                     const void* n0, const void* n1, const void* n2,          \
                     const void* rt, const int* cells, const void* flux,      \
                     const void* rec, const int* bands, void* out0,           \
                     void* out1, void* out2, void* out3, int B, int Dc,       \
                     int Ds, int rb0, int n_valid, double dr, double sdr3,    \
                     void* stream) {                                          \
    using P = const T*;                                                       \
    return cheb::launch_rates_he<T>(                                          \
        cheb::HeRates<T>{{(P)cd0, (P)cd1, (P)cd2},                            \
                         {(P)n0, (P)n1, (P)n2},                               \
                         (P)rt, cells, (P)flux, (P)rec,                       \
                         cheb::he_bands_of(bands),                            \
                         {static_cast<T*>(out0), static_cast<T*>(out1),       \
                          static_cast<T*>(out2), static_cast<T*>(out3)},      \
                         B, Dc, Ds, rb0, n_valid, static_cast<T>(dr),         \
                         static_cast<T>(sdr3)},                               \
        static_cast<cudaStream_t>(stream));                                   \
  }

RATES_HE_ENTRY(f32, float)
RATES_HE_ENTRY(f64, double)

const char* cheb_rates_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
