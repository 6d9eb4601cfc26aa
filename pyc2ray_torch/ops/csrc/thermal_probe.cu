// The thermal update's design steps and the check of its pow pair, for
// chip_smoke.py's tables and the cuda tests alone (only they build this
// source; the engine's library, thermal.cu, holds the engine's kernels).
//
//   the forms   thermal_kernel (thermal.cuh) at each step of the redesign
//               (thermal.cuh's run_form, THERMAL_FORMS in chip_smoke.py).
//               Every form gives the plain version's bits.
//   the pair    pow_pair (thermal.cuh) against pow_ (powf, pow) bit for bit
//               at pairs of exponents, over every float between two bit
//               patterns or over a tensor of bases: the count of results
//               whose bits differ.

#include "thermal.cuh"

using namespace thermal;

namespace {

constexpr int kMaxY = 32;

// exponents in pairs (y, y - 1), in the type and as the pair's tail takes
// them
template <typename T>
struct PairYs {
  T y[kMaxY], z[kMaxY];
  int n;
};

template <typename T>
__device__ __forceinline__ bool same_bits(T a, T b) {
  if constexpr (sizeof(T) == 4)
    return __float_as_int(a) == __float_as_int(b);
  else
    return __double_as_longlong(a) == __double_as_longlong(b);
}

// the bases x[i] (x null: the float of bits lo_bits + i), i < n
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_check_kernel(const T* x, long long n, unsigned lo_bits, PairYs<T> ys,
                      unsigned long long* bad) {
  unsigned long long miss = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    T u;
    if constexpr (sizeof(T) == 4)
      u = x ? x[i] : __int_as_float(static_cast<int>(
                         lo_bits + static_cast<unsigned>(i)));
    else
      u = x[i];
    for (int j = 0; j + 1 < ys.n; j += 2) {
      T p1, p2;
      pow_pair(u, ys.y[j], ys.z[j], ys.y[j + 1], ys.z[j + 1], &p1, &p2);
      miss += !same_bits(p1, pow_(u, ys.y[j]));
      miss += !same_bits(p2, pow_(u, ys.y[j + 1]));
    }
  }
  if (miss) atomicAdd(bad, miss);
}

template <typename T>
int pair_check(const void* x, long long n, unsigned lo_bits, const double* ys,
               int ny, void* bad, cudaStream_t st) {
  if (ny > kMaxY || ny % 2 != 0 || (sizeof(T) == 8 && x == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PairYs<T> p{};
  p.n = ny;
  for (int j = 0; j < ny; ++j) {
    p.y[j] = static_cast<T>(ys[j]);
    p.z[j] = pair_exponent(p.y[j]);
  }
  const long long g = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(g < 1 ? 1 : g > 8192 ? 8192 : g);
  pair_check_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), n, lo_bits, p,
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The update (thermal.cu's thermal_update_f32/_f64 arguments) by the
// probe's form `form`.
#define THERMAL_PROBE_ENTRY(NAME, TYPE)                                        \
  int NAME(int form, const void* dt_ptr, int dt_kind, double dt_value,        \
           const void* temp, const void* ndens, const void* xh,               \
           const void* heat, void* out, long long n, int nsub,               \
           const double* params, void* stream) {                              \
    using P = const TYPE*;                                                     \
    TArgs<TYPE> a{static_cast<P>(temp), static_cast<P>(ndens),                 \
                  static_cast<P>(xh),   static_cast<P>(heat),                  \
                  static_cast<TYPE*>(out), n, nsub,                            \
                  Dt{dt_ptr, dt_kind, dt_value},                               \
                  t_const<TYPE>(params, nsub)};                                \
    return run_form(form, a, CudaLaunch{static_cast<cudaStream_t>(stream)}); \
  }

THERMAL_PROBE_ENTRY(thermal_probe_f32, float)
THERMAL_PROBE_ENTRY(thermal_probe_f64, double)

// Adds to *bad (an unsigned 64-bit count on the device) the results of
// pow_pair that differ from pow_ in their bits: bases x[i], i < n (float32
// with x null: the floats of bits lo_bits + i), exponents ys[0..ny) in
// pairs (y, y - 1), rounded to the type.
#define THERMAL_PAIR_ENTRY(NAME, TYPE)                                         \
  int NAME(const void* x, long long n, unsigned lo_bits, const double* ys,    \
           int ny, void* bad, void* stream) {                                 \
    return pair_check<TYPE>(x, n, lo_bits, ys, ny, bad,                        \
                            static_cast<cudaStream_t>(stream));               \
  }

THERMAL_PAIR_ENTRY(thermal_pair_check_f32, float)
THERMAL_PAIR_ENTRY(thermal_pair_check_f64, double)

const char* thermal_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
