// Device code shared by the Chebyshev-face sweep kernels for NVIDIA Hopper:
// cheb_sweep.cu (K1, K1f, K2) and cheb_sweep_rates.cu (K3, K3h).
//
// The sweep runs, per source of a batch, over cube shells r with three face
// sub-steps x -> y -> z. A face cell (sign s, plane coordinates a, b) reads
// four cells of its stencil plane P (the plane at distance r-1, stitched
// from the other faces' planes):
//   cdin = diag * sum_i w_i P_i / sum_i w_i,  w_i = s_i / max(0.6, P_i sig)
//   dcol = nHI * (path * dr)
//   out  = mask ? cdin + dcol : 0
// `out` enters the shell state. What a kernel keeps of a valid face cell
// (its cd, its Gamma, or its cdin and dcol) is decided by a Store functor
// handed to face_step, so the sweep itself is written once. A valid face
// cell lies inside the box, at its cartesian position
// (x face -> [c-+r, a, b], y -> [a, c-+r, b], z -> [a, b, c-+r]); face
// memberships are disjoint, so every box cell is stored at most once.
//
// The X/Y/Z planes of shells r-1 and r live in a per-block scratch of 12
// planes, [parity][face][sign][a][b] with parity = shell & 1.
//
// All arithmetic uses the explicitly rounded intrinsics (no FMA
// contraction), so every operation rounds as in the plain PyTorch version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cheb {

constexpr double kFourPi = 12.566370614359172463991853874177;
constexpr double kMaxColdensH = 2.0e30;   // rates are zeroed above this cdin

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float expm1(float x) { return expm1f(x); }
  static constexpr float tiny = 1.17549435e-38f;     // torch.finfo(float32).tiny
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double expm1(double x) { return ::expm1(x); }
  static constexpr double tiny = 2.2250738585072014e-308;
};

// max(lim, x) with NaN in x propagated, as torch.maximum / clamp do.
template <typename T>
__device__ __forceinline__ T max_lim(T lim, T x) { return x < lim ? lim : x; }

// Read-only inputs of the sweep: the geometry tables (ops/cheb_geometry.py)
// for shells 0..R1-1 and the scalars.
template <typename T>
struct Tables {
  const T* sw;              // (3, 4, R1, Dc, Dc)
  const T* path;            // (3, R1, Dc, Dc)
  const T* diag;            // (3, R1, Dc, Dc)
  const uint8_t* mask_m;    // (3, R1, Dc, Dc) bool
  const uint8_t* mask_p;
  int Dc, c, R1;
  T dr, sig;
};

// Per-shell constants shared by the three sub-steps.
struct Shell {
  int r, c, Dc, alo, ahi;
  bool ok_lo, ok_hi;
  __device__ int pos(int s) const { return s ? ahi : alo; }
};

// A valid face cell handed to a Store: its cartesian offset in the box and
// its values.
template <typename T>
struct FaceCell {
  size_t o;
  T cdin, dcol, nhi, path, out;
};

// Stencil planes of the x faces: X[r-1]; rows j = alo/ahi from Y[r-1];
// cols k = alo/ahi from Z[r-1] (later writes of the reference win).
template <typename T>
__device__ __forceinline__ T stencil_x(const Shell& S, const T* Xp, const T* Yp,
                                       const T* Zp, int s, int a, int b) {
  const int D = S.Dc, D2 = D * D;
  if (b == S.ahi) return Zp[1 * D2 + S.pos(s) * D + a];
  if (b == S.alo) return Zp[0 * D2 + S.pos(s) * D + a];
  if (a == S.ahi) return Yp[1 * D2 + S.pos(s) * D + b];
  if (a == S.alo) return Yp[0 * D2 + S.pos(s) * D + b];
  return Xp[s * D2 + a * D + b];
}

// y faces: Y[r-1]; cols k = alo/ahi from Z[r-1]; rows i = c-+r from X[r].
template <typename T>
__device__ __forceinline__ T stencil_y(const Shell& S, const T* Yp, const T* Zp,
                                       const T* Xn, int s, int a, int b) {
  const int D = S.Dc, D2 = D * D;
  if (S.ok_hi && a == S.c + S.r) return Xn[1 * D2 + S.pos(s) * D + b];
  if (S.ok_lo && a == S.c - S.r) return Xn[0 * D2 + S.pos(s) * D + b];
  if (b == S.ahi) return Zp[1 * D2 + a * D + S.pos(s)];
  if (b == S.alo) return Zp[0 * D2 + a * D + S.pos(s)];
  return Yp[s * D2 + a * D + b];
}

// z faces: Z[r-1]; rows i = c-+r from X[r]; cols j = c-+r from Y[r].
template <typename T>
__device__ __forceinline__ T stencil_z(const Shell& S, const T* Zp, const T* Xn,
                                       const T* Yn, int s, int a, int b) {
  const int D = S.Dc, D2 = D * D;
  if (S.ok_hi && b == S.c + S.r) return Yn[1 * D2 + a * D + S.pos(s)];
  if (S.ok_lo && b == S.c - S.r) return Yn[0 * D2 + a * D + S.pos(s)];
  if (S.ok_hi && a == S.c + S.r) return Xn[1 * D2 + b * D + S.pos(s)];
  if (S.ok_lo && a == S.c - S.r) return Xn[0 * D2 + b * D + S.pos(s)];
  return Zp[s * D2 + a * D + b];
}

// One face pair of shell r: face F (0 = x, 1 = y, 2 = z). Writes the new
// (masked) plane to `out` and hands every valid cell to `store`.
template <typename T, int F, class Store>
__device__ void face_step(const Shell& S, const Tables<T>& tb,
                          const T* __restrict__ nhi, const T* P0, const T* P1,
                          const T* P2, T* out, const Store& store) {
  using A = Arith<T>;
  const int D = S.Dc, D2 = D * D;
  const T lim = T(0.6);
  const int lo = max(S.c - S.r, 0), hi = min(S.c + S.r, D - 1);
  const size_t g = (size_t(F) * tb.R1 + S.r) * D2;    // (f, r) plane offset
  const size_t gs = size_t(tb.R1) * D2;                // stride of sw's k
  for (int idx = threadIdx.x; idx < 2 * D2; idx += blockDim.x) {
    const int s = idx / D2, a = (idx / D) % D, b = idx % D;
    const int a1 = a >= S.c ? max(a - 1, 0) : min(a + 1, D - 1);
    const int b1 = b >= S.c ? max(b - 1, 0) : min(b + 1, D - 1);
    T P, Pa, Pb, Pab;
    if (F == 0) {
      P = stencil_x(S, P0, P1, P2, s, a, b);
      Pa = stencil_x(S, P0, P1, P2, s, a1, b);
      Pb = stencil_x(S, P0, P1, P2, s, a, b1);
      Pab = stencil_x(S, P0, P1, P2, s, a1, b1);
    } else if (F == 1) {
      P = stencil_y(S, P0, P1, P2, s, a, b);
      Pa = stencil_y(S, P0, P1, P2, s, a1, b);
      Pb = stencil_y(S, P0, P1, P2, s, a, b1);
      Pab = stencil_y(S, P0, P1, P2, s, a1, b1);
    } else {
      P = stencil_z(S, P0, P1, P2, s, a, b);
      Pa = stencil_z(S, P0, P1, P2, s, a1, b);
      Pb = stencil_z(S, P0, P1, P2, s, a, b1);
      Pab = stencil_z(S, P0, P1, P2, s, a1, b1);
    }
    const size_t ab = size_t(a) * D + b;
    const size_t gk = size_t(F) * 4 * gs + size_t(S.r) * D2 + ab;
    const T w1 = A::div(tb.sw[gk + 0 * gs], max_lim(lim, A::mul(Pab, tb.sig)));
    const T w2 = A::div(tb.sw[gk + 1 * gs], max_lim(lim, A::mul(Pb, tb.sig)));
    const T w3 = A::div(tb.sw[gk + 2 * gs], max_lim(lim, A::mul(Pa, tb.sig)));
    const T w4 = A::div(tb.sw[gk + 3 * gs], max_lim(lim, A::mul(P, tb.sig)));
    T num = A::add(A::add(A::add(A::mul(Pab, w1), A::mul(Pb, w2)),
                          A::mul(Pa, w3)), A::mul(P, w4));
    T den = A::add(A::add(A::add(w1, w2), w3), w4);
    const T cdin = A::div(A::mul(tb.diag[g + ab], num), den);
    const int plane = s ? hi : lo;                     // clamped nHI plane
    T n;
    if (F == 0) n = nhi[size_t(plane) * D2 + ab];
    else if (F == 1) n = nhi[size_t(a) * D2 + size_t(plane) * D + b];
    else n = nhi[size_t(a) * D2 + size_t(b) * D + plane];
    const T pth = tb.path[g + ab];
    const T dcol = A::mul(n, A::mul(pth, tb.dr));
    const bool m = (s ? tb.mask_p : tb.mask_m)[g + ab] != 0;
    const T v = m ? A::add(cdin, dcol) : T(0);
    out[idx] = v;
    if (m) {                      // valid cells lie inside the box
      const int q = s ? S.c + S.r : S.c - S.r;
      size_t o;
      if (F == 0) o = size_t(q) * D2 + ab;
      else if (F == 1) o = size_t(a) * D2 + size_t(q) * D + b;
      else o = size_t(a) * D2 + size_t(b) * D + q;
      store(FaceCell<T>{o, cdin, dcol, n, pth, v});
    }
  }
}

// Shells r0 .. r1-1, each reading the planes of shell r-1 from the scratch
// `sc` (parity (r-1) & 1) and writing its own (parity r & 1). Ends with a
// __syncthreads(), so the last shell's planes are visible to the block.
template <typename T, class Store>
__device__ void sweep_shells(const Tables<T>& tb, const T* __restrict__ nhi,
                             T* sc, int r0, int r1, const Store& store) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc;
  for (int r = r0; r < r1; ++r) {
    Shell S;
    S.r = r; S.c = tb.c; S.Dc = tb.Dc;
    S.alo = tb.c - r + 1; S.ahi = tb.c + r - 1;
    S.ok_lo = tb.c - r >= 0; S.ok_hi = tb.c + r <= tb.Dc - 1;
    const T* prev = sc + ((r - 1) & 1) * 6 * D2;
    T* cur = sc + (r & 1) * 6 * D2;
    const T *Xp = prev, *Yp = prev + 2 * D2, *Zp = prev + 4 * D2;
    T *Xn = cur, *Yn = cur + 2 * D2, *Zn = cur + 4 * D2;
    face_step<T, 0>(S, tb, nhi, Xp, Yp, Zp, Xn, store);
    __syncthreads();
    face_step<T, 1>(S, tb, nhi, Yp, Zp, Xn, Yn, store);
    __syncthreads();
    face_step<T, 2>(S, tb, nhi, Zp, Xn, Yn, Zn, store);
    __syncthreads();
  }
}

template <typename T>
__device__ void fill_zero(T* p, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) p[i] = T(0);
}

// The source cell's outgoing column density nHI_c * dr / 2.
template <typename T>
__device__ T source_cd(const Tables<T>& tb, const T* nhi) {
  const size_t c = tb.c, D = tb.Dc;
  return Arith<T>::mul(nhi[(c * D + c) * D + c], Arith<T>::mul(T(0.5), tb.dr));
}

// Shell 0's planes (parity 0 of `sc`): zero, with the source cell of every
// face and sign set to src_cd. Ends with a __syncthreads().
template <typename T>
__device__ void init_planes(const Tables<T>& tb, T* sc, T src_cd) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc;
  fill_zero(sc, 6 * D2);
  __syncthreads();
  for (int p = threadIdx.x; p < 6; p += blockDim.x)   // face x sign
    sc[p * D2 + size_t(tb.c) * tb.Dc + tb.c] = src_cd;
  __syncthreads();
}

// The E spectral bins into shared memory `sm`: s, then w, then (when `wh` is
// not null) the heating weights w_heat; 2E or 3E values. Ends with a
// __syncthreads().
template <typename T>
__device__ void load_bins(const T* s, const T* w, int E, T* sm,
                          const T* wh = nullptr) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    sm[e] = s[e];
    sm[E + e] = w[e];
    if (wh != nullptr) sm[2 * E + e] = wh[e];
  }
  __syncthreads();
}

// acc = sum_e w_e core_e and, with HEAT, acc_h = sum_e w_heat_e core_e over
// the same core_e = exp(-tau_in s_e) (-expm1(-dtau s_e)): one exp and one
// expm1 per bin feed both sums. Bins in `sm` as load_bins lays them out.
template <typename T, bool HEAT>
__device__ __forceinline__ void bin_sums(T tau_in, T dtau, const T* sm, int E,
                                         T& acc, T& acc_h) {
  using A = Arith<T>;
  acc = T(0);
  acc_h = T(0);
  for (int e = 0; e < E; ++e) {
    const T core = A::mul(A::exp(-A::mul(tau_in, sm[e])),
                          -A::expm1(-A::mul(dtau, sm[e])));
    acc = A::add(acc, A::mul(sm[E + e], core));
    if (HEAT) acc_h = A::add(acc_h, A::mul(sm[2 * E + e], core));
  }
}

// sum_e w_e exp(-tau_in s_e) (-expm1(-dtau s_e)), bins in `sm` as above.
template <typename T>
__device__ __forceinline__ T bin_sum(T tau_in, T dtau, const T* sm, int E) {
  T acc, acc_h;
  bin_sums<T, false>(tau_in, dtau, sm, E, acc, acc_h);
  return acc;
}

// Dynamic shared memory as an array of T (one extern declaration for all
// instantiations).
template <typename T>
__device__ T* shared_bins() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

}  // namespace cheb
