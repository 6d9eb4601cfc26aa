// The thermal update on NVIDIA Hopper (sm_90a): ops/thermal.py's
// update_temperature as one kernel launch, one thread per cell, the nsub
// exponential-Euler substeps in registers.
//
// Counterpart of the JAX package's jax.lax.fori_loop of
// pyc2ray_tpu/ops/thermal.py::update_temperature (:101-132), which XLA runs
// on the device as one program. No TPU kernel of its own. Plain version:
// pyc2ray_torch/ops/thermal.py::update_temperature_ref, the loop of PyTorch
// operations with torch.func.jvp for dLambda/dT (dozens of launches a
// substep).
//
//   thermal_kernel   per cell: the heating, the heat capacity and the
//                    densities once; per substep Lambda and dLambda/dT (the
//                    five cooling terms, Compton under a flag), the
//                    relaxation factor phi1(-b h) and the clamped step.
//
// Rounding. Every operation is the one the plain version issues on the
// card, in its order and its type: explicitly rounded intrinsics (no FMA
// contraction); a Python scalar rounded to the type before the operation
// (the host forms the products of Python scalars, such as 0.75 KB, in
// double as Python does); a division by a Python scalar as a multiply by
// its reciprocal in the type (ATen's div_true with a CPU scalar); a scalar
// over a tensor as the tensor's reciprocal times the scalar; pow, exp,
// expm1 and sqrt as the same CUDA math functions; clamp with ATen's NaN
// rule. The derivative is written out as torch.func.jvp's forward-mode
// formulas issue it with the tangent dT = 1 (derivatives.yaml): a * b ->
// a' b + b' a, a / b -> (a' - b' (a / b)) / b, 1 / x -> (-x') (r r),
// exp -> x' e, sqrt -> x' / (2 s), x^p -> x' (x^(p - 1) p), a term
// without T a constant (no operation). So the result equals the plain
// version's bit for bit.
//
// Bound. The update reads four fields and writes one (20 bytes a float32
// cell, 0.100 ms for 256^3 cells at 3.35 TB/s); each of its 16 substeps
// takes two pow, two exp, two sqrt, an expm1 and six divisions a cell, so
// the transcendentals on the MUFU pipe bind (chip_smoke's THERMAL_MUFU).

#include <cuda_runtime.h>
#include <stdint.h>

namespace thermal {

constexpr int kThreads = 256;

#include "rounded.cuh"

// The update's scalars, each rounded to T as the plain version rounds it.
// Host order of the doubles (ops/thermal.py::_kernel_params): 1.5 KB,
// abu_c, albpow, bh00, 0.75 KB, E_HI colh0, -temph0, -118348, 7.5e-19,
// 1.42e-27 gaunt_ff, Compton (0 or 1), T_cmb(z), 5.65e-36 (1 + z)^4,
// t_floor, t_cap.
constexpr int kTParams = 15;
template <typename T>
struct TConst {
  T c_hc, abu_c, albpow, albpow_m1, bh00, c_rec, c_col, neg_temph0;
  T neg_lya, c_lya, c_ff, t_cmb, c_comp, t_floor, t_cap;
  T inv_1e4, inv_1e5, inv_nsub, phi_tiny;
  bool compton;
};

template <typename T>
TConst<T> t_const(const double* p, int nsub) {
  TConst<T> k;
  k.c_hc = static_cast<T>(p[0]);
  k.abu_c = static_cast<T>(p[1]);
  k.albpow = static_cast<T>(p[2]);
  k.albpow_m1 = static_cast<T>(p[2] - 1.0);   // pow's tangent: exponent - 1
  k.bh00 = static_cast<T>(p[3]);
  k.c_rec = static_cast<T>(p[4]);
  k.c_col = static_cast<T>(p[5]);
  k.neg_temph0 = static_cast<T>(p[6]);
  k.neg_lya = static_cast<T>(p[7]);
  k.c_lya = static_cast<T>(p[8]);
  k.c_ff = static_cast<T>(p[9]);
  k.compton = p[10] != 0.0;
  k.t_cmb = static_cast<T>(p[11]);
  k.c_comp = static_cast<T>(p[12]);
  k.t_floor = static_cast<T>(p[13]);
  k.t_cap = static_cast<T>(p[14]);
  k.inv_1e4 = static_cast<T>(1.0) / static_cast<T>(1.0e4);
  k.inv_1e5 = static_cast<T>(1.0) / static_cast<T>(1.0e5);
  k.inv_nsub = static_cast<T>(1.0) / static_cast<T>(nsub);
  k.phi_tiny = static_cast<T>(1.0e-8);
  return k;
}

// What a cell keeps over its substeps (the plain version's tensors that do
// not depend on T).
template <typename T>
struct TCell {
  T heat_vol, inv_hc, ne, n_hii, n_hi;
};

template <typename T>
__device__ __forceinline__ TCell<T> t_cell(T nd, T xh, T heat,
                                           const TConst<T>& k) {
  TCell<T> c;
  const T n_hi = mul(nd, sub(T(1), xh));
  c.heat_vol = mul(n_hi, heat);
  const T ntot = mul(nd, add(add(xh, T(1)), k.abu_c));
  c.inv_hc = mul(div(T(1), mul(ntot, k.c_hc)), T(1));
  c.ne = mul(nd, add(xh, k.abu_c));
  c.n_hii = mul(nd, xh);
  c.n_hi = n_hi;
  return c;
}

// Lambda(T) (ops/thermal.py::cooling_rate) in *lam and its derivative in
// *dlam, each term's value and tangent (suffix _t) as the plain version's
// primal and jvp operations give them.
template <typename T>
__device__ __forceinline__ void cooling(T temp, const TCell<T>& c,
                                        const TConst<T>& k, T* lam,
                                        T* dlam) {
  const T one = T(1);                     // the tangent dT
  const T sq = sqrt_(temp);
  const T sq_t = div(one, mul(sq, T(2)));
  // recombination: ((0.75 KB T) (bh00 (T / 1e4)^albpow)) n_e n_HII
  const T u = mul(temp, k.inv_1e4), u_t = mul(one, k.inv_1e4);
  const T pw = pow_(u, k.albpow);
  const T pw_t = mul(u_t, mul(pow_(u, k.albpow_m1), k.albpow));
  const T al = mul(pw, k.bh00), al_t = mul(pw_t, k.bh00);
  const T a = mul(temp, k.c_rec), a_t = mul(one, k.c_rec);
  const T b = mul(a, al), b_t = add(mul(a_t, al), mul(al_t, a));
  const T l_rec = mul(mul(b, c.ne), c.n_hii);
  const T l_rec_t = mul(mul(b_t, c.ne), c.n_hii);
  // collisional ionisation: ((E_HI colh0 sqrt T) exp(-temph0 / T)) n_e n_HI
  const T r = div(T(1), temp);
  const T r_t = mul(-one, mul(r, r));
  const T x1 = mul(r, k.neg_temph0), x1_t = mul(r_t, k.neg_temph0);
  const T e1 = exp_(x1), e1_t = mul(x1_t, e1);
  const T s = mul(sq, k.c_col), s_t = mul(sq_t, k.c_col);
  const T d = mul(s, e1), d_t = add(mul(s_t, e1), mul(e1_t, s));
  const T l_coll = mul(mul(d, c.ne), c.n_hi);
  const T l_coll_t = mul(mul(d_t, c.ne), c.n_hi);
  // Ly-alpha: (7.5e-19 exp(-118348 / T)) / (1 + sqrt(T / 1e5)) n_e n_HI
  const T x2 = mul(r, k.neg_lya), x2_t = mul(r_t, k.neg_lya);
  const T e2 = exp_(x2), e2_t = mul(x2_t, e2);
  const T num = mul(e2, k.c_lya), num_t = mul(e2_t, k.c_lya);
  const T v = mul(temp, k.inv_1e5), v_t = mul(one, k.inv_1e5);
  const T sv = sqrt_(v), sv_t = div(v_t, mul(sv, T(2)));
  const T den = add(sv, T(1));
  const T q = div(num, den), q_t = div(sub(num_t, mul(sv_t, q)), den);
  const T l_lya = mul(mul(q, c.ne), c.n_hi);
  const T l_lya_t = mul(mul(q_t, c.ne), c.n_hi);
  // free-free: (1.42e-27 gaunt_ff sqrt T) n_e n_HII
  const T f = mul(sq, k.c_ff), f_t = mul(sq_t, k.c_ff);
  const T l_ff = mul(mul(f, c.ne), c.n_hii);
  const T l_ff_t = mul(mul(f_t, c.ne), c.n_hii);
  T l = add(add(add(l_rec, l_coll), l_lya), l_ff);
  T l_t = add(add(add(l_rec_t, l_coll_t), l_lya_t), l_ff_t);
  if (k.compton) {
    // Compton: (5.65e-36 (1 + z)^4 (T - T_cmb)) n_e
    const T w = mul(sub(temp, k.t_cmb), k.c_comp), w_t = mul(one, k.c_comp);
    l = add(l, mul(w, c.ne));
    l_t = add(l_t, mul(w_t, c.ne));
  }
  *lam = l;
  *dlam = l_t;
}

// One exponential-Euler substep of length h from temp.
template <typename T>
__device__ __forceinline__ T substep(T temp, T h, const TCell<T>& c,
                                     const TConst<T>& k) {
  T lam, dlam;
  cooling(temp, c, k, &lam, &dlam);
  const T r0 = mul(sub(c.heat_vol, lam), c.inv_hc);
  const T x = mul(mul(dlam, c.inv_hc), h);
  // phi1(-x) = (1 - e^-x) / x where |x| > 1e-8, else 1
  T phi = T(1);
  if (abs_(x) > k.phi_tiny) phi = div(-expm1_(-x), x == T(0) ? T(1) : x);
  return clamp(add(temp, mul(mul(r0, h), phi)), k.t_floor, k.t_cap);
}

template <typename T>
struct TArgs {
  const T *temp, *ndens, *xh, *heat;
  T* out;
  long long n;
  int nsub;
  Dt dt;
  TConst<T> k;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) thermal_kernel(TArgs<T> a) {
  const TConst<T>& k = a.k;
  // h = dt / nsub: dt in the fields' type, times the reciprocal of nsub
  const T h = mul(static_cast<T>(a.dt.read()), k.inv_nsub);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < a.n; i += stride) {
    const TCell<T> c = t_cell(a.ndens[i], a.xh[i], a.heat[i], k);
    T temp = a.temp[i];
    for (int s = 0; s < a.nsub; ++s) temp = substep(temp, h, c, k);
    a.out[i] = temp;
  }
}

// The launch of the thermal kernel

unsigned grid_for(long long n) {
  const long long g = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(g < 1 ? 1 : g > 0x7fffffffLL ? 0x7fffffffLL : g);
}

template <typename T>
int launch(TArgs<T> a, cudaStream_t st) {
  thermal_kernel<T><<<grid_for(a.n), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace thermal

using namespace thermal;

extern "C" {

// The update over n cells on `stream`: temp, ndens, xh and heat in, the
// new temperature into `out`; dt from `dt_ptr` (a 0-dim tensor on the
// device, dt_kind 1 float32, 2 float64) or `dt_value` (dt_kind 0); nsub
// substeps; `params` the kTParams doubles. Returns the cudaError_t of the
// launch.
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
    return launch<TYPE>(a, static_cast<cudaStream_t>(stream));                \
  }

THERMAL_ENTRY(thermal_update_f32, float)
THERMAL_ENTRY(thermal_update_f64, double)

const char* thermal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
