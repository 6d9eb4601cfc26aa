// Explicitly rounded arithmetic for the kernels that equal a plain PyTorch
// version bit for bit (chemistry.cu, thermal.cuh, flat_sweep.cuh): each
// operation in float and double as ATen's CUDA kernels compute it (no FMA
// contraction; pow, exp, expm1, log10, sqrt and rsqrt the same CUDA math
// functions; rcp the correctly rounded 1 / x), ATen's NaN rules for clamp
// and maximum, and dt as the plain versions read it. Included inside each
// kernel's namespace, so it has no guard and includes nothing.

#define ROUNDED_OP2(NAME, F32, F64)                               \
  __device__ __forceinline__ float NAME(float a, float b) {       \
    return F32(a, b);                                             \
  }                                                               \
  __device__ __forceinline__ double NAME(double a, double b) {    \
    return F64(a, b);                                             \
  }
#define ROUNDED_OP1(NAME, F32, F64)                               \
  __device__ __forceinline__ float NAME(float a) { return F32(a); } \
  __device__ __forceinline__ double NAME(double a) { return F64(a); }
ROUNDED_OP2(add, __fadd_rn, __dadd_rn)
ROUNDED_OP2(sub, __fsub_rn, __dsub_rn)
ROUNDED_OP2(mul, __fmul_rn, __dmul_rn)
ROUNDED_OP2(div, __fdiv_rn, __ddiv_rn)
ROUNDED_OP2(pow_, powf, pow)
ROUNDED_OP2(max_, fmaxf, fmax)
ROUNDED_OP2(min_, fminf, fmin)
ROUNDED_OP1(exp_, expf, exp)
ROUNDED_OP1(expm1_, expm1f, expm1)
ROUNDED_OP1(log10_, log10f, log10)
ROUNDED_OP1(sqrt_, sqrtf, sqrt)
ROUNDED_OP1(rsqrt_, rsqrtf, rsqrt)
ROUNDED_OP1(rcp, __frcp_rn, __drcp_rn)
ROUNDED_OP1(abs_, fabsf, fabs)
#undef ROUNDED_OP1
#undef ROUNDED_OP2

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }
// torch.clamp (NaN passes), torch.maximum (NaN wins)
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return is_nan(v) ? v : max_(v, lo);
}
template <typename T>
__device__ __forceinline__ T clamp_max(T v, T hi) {
  return is_nan(v) ? v : min_(v, hi);
}
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  return is_nan(v) ? v : min_(max_(v, lo), hi);
}
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return is_nan(a) ? a : (is_nan(b) ? b : max_(a, b));
}

// dt as the plain version reads it: a 0-dim float32 or float64 tensor on
// the device (kind 1, 2) or a Python number (kind 0, `value`).
struct Dt {
  const void* ptr;
  int kind;
  double value;
  __device__ double read() const {
    if (kind == 1) return static_cast<double>(*static_cast<const float*>(ptr));
    if (kind == 2) return *static_cast<const double*>(ptr);
    return value;
  }
};
