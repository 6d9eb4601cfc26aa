// Chebyshev-face column-density sweep for NVIDIA Hopper (sm_90a).
//
// Replaces pyc2ray_tpu/ops/pallas_sweep.py::cheb_sweep_pallas (K1; body
// _kernel, _shell_update, _face_update), followed by the stack-to-box fold
// of raytrace_cheb.py::_fold_stacks_packed. Plain version:
// pyc2ray_torch/ops/sweep.py::cheb_sweep_ref.
//
// What it computes, per source b of a batch: a loop over cube shells
// r = 1..R1-1, each with three face sub-steps x -> y -> z. A face cell
// (sign s, plane coordinates a, b) reads four cells of its stencil plane P
// (the plane at distance r-1, stitched from the other faces' planes):
//   cdin = diag * sum_i w_i P_i / sum_i w_i,  w_i = s_i / max(0.6, P_i sig)
//   out  = mask ? cdin + nHI * path * dr : 0
// and the masked value is written straight into the cartesian box
// (x face -> box[c-+r, a, b], y -> box[a, c-+r, b], z -> box[a, b, c-+r]).
// Face memberships are disjoint, so this equals the fold of the face
// stacks exactly; the source cell gets nHI_c * dr / 2.
//
// Design. The TPU kernel's lane packing, rolls and masked-select stitches
// are register devices of that machine and are not copied: here a thread
// computes the stitched stencil value of any plane cell by a direct
// lookup in the r-1 planes (and the same shell's x/y planes), with the
// stitch precedence of the reference written as an if-chain. One block per
// source (the two signs of a face are coupled by the stitches, so they
// share a block); the block's threads sweep the 2*Dc*Dc cells of one face
// pair, then __syncthreads() before the next sub-step, which reads them.
// The X/Y/Z planes of shells r-1 and r live in a per-block global scratch
// buffer (ping-pong by shell parity; 12 planes, 196 KB in f32 at Dc = 64),
// small enough to stay in the 50 MB L2.
//
// Bound. The function reads the nHI box and the geometry tables once and
// writes the cd box once: at B = 8, Dc = 64, R1 = 31 in f32 that is
// 8 MB + 8 MB + ~10 MB, about 8 us at 3.35 TB/s; its arithmetic (~30
// flops per face cell) is below that. This kernel is far from the bound:
// its 3 (R1 - 1) dependent sub-steps run on only B blocks of 132 SMs, and
// each sub-step is L2-latency-bound. Shared-memory planes, several blocks
// per source and fusing the rate pass are the next steps.
//
// Arithmetic uses the explicitly rounded intrinsics (no FMA contraction),
// so every operation rounds as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

// max(lim, x) with NaN in x propagated, as torch.maximum does.
template <typename T>
__device__ __forceinline__ T max_lim(T lim, T x) { return x < lim ? lim : x; }

// Per-shell constants shared by the three sub-steps.
struct Shell {
  int r, c, Dc, alo, ahi;
  bool ok_lo, ok_hi;
  __device__ int pos(int s) const { return s ? ahi : alo; }
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

// One face pair of shell r: face f (0 = x, 1 = y, 2 = z). Writes the new
// (masked) plane to `out` and the valid cells into the box.
template <typename T, int F>
__device__ void face_step(const Shell& S, const T* __restrict__ nhi,
                          const T* __restrict__ sw, const T* __restrict__ path,
                          const T* __restrict__ diag,
                          const uint8_t* __restrict__ mask_m,
                          const uint8_t* __restrict__ mask_p,
                          const T* P0, const T* P1, const T* P2, T* out,
                          T* box, int R1, T dr, T sig) {
  using A = Arith<T>;
  const int D = S.Dc, D2 = D * D;
  const T lim = T(0.6);
  const int lo = max(S.c - S.r, 0), hi = min(S.c + S.r, D - 1);
  const size_t g = (size_t(F) * R1 + S.r) * D2;       // (f, r) plane offset
  const size_t gs = size_t(R1) * D2;                   // stride of sw's k
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
    const T w1 = A::div(sw[gk + 0 * gs], max_lim(lim, A::mul(Pab, sig)));
    const T w2 = A::div(sw[gk + 1 * gs], max_lim(lim, A::mul(Pb, sig)));
    const T w3 = A::div(sw[gk + 2 * gs], max_lim(lim, A::mul(Pa, sig)));
    const T w4 = A::div(sw[gk + 3 * gs], max_lim(lim, A::mul(P, sig)));
    T num = A::add(A::add(A::add(A::mul(Pab, w1), A::mul(Pb, w2)),
                          A::mul(Pa, w3)), A::mul(P, w4));
    T den = A::add(A::add(A::add(w1, w2), w3), w4);
    const T cdin = A::div(A::mul(diag[g + ab], num), den);
    const int plane = s ? hi : lo;                     // clamped nHI plane
    T n;
    if (F == 0) n = nhi[size_t(plane) * D2 + ab];
    else if (F == 1) n = nhi[size_t(a) * D2 + size_t(plane) * D + b];
    else n = nhi[size_t(a) * D2 + size_t(b) * D + plane];
    const bool m = (s ? mask_p : mask_m)[g + ab] != 0;
    const T v = m ? A::add(cdin, A::mul(n, A::mul(path[g + ab], dr))) : T(0);
    out[idx] = v;
    if (m) {                      // valid cells lie inside the box
      const int q = s ? S.c + S.r : S.c - S.r;
      size_t o;
      if (F == 0) o = size_t(q) * D2 + ab;
      else if (F == 1) o = size_t(a) * D2 + size_t(q) * D + b;
      else o = size_t(a) * D2 + size_t(b) * D + q;
      box[o] = v;
    }
  }
}

template <typename T>
__global__ void cheb_sweep_kernel(const T* __restrict__ nhi_all,
                                  const T* __restrict__ sw,
                                  const T* __restrict__ path,
                                  const T* __restrict__ diag,
                                  const uint8_t* __restrict__ mask_m,
                                  const uint8_t* __restrict__ mask_p,
                                  T* box_all, T* scratch_all,
                                  int Dc, int c, int R1, T dr, T sig) {
  using A = Arith<T>;
  const size_t D2 = size_t(Dc) * Dc, D3 = D2 * Dc;
  const T* nhi = nhi_all + blockIdx.x * D3;
  T* box = box_all + blockIdx.x * D3;
  T* sc = scratch_all + blockIdx.x * 12 * D2;   // [parity][face][sign][a][b]
  const T src_cd = A::mul(nhi[c * D2 + size_t(c) * Dc + c], A::mul(T(0.5), dr));

  for (size_t i = threadIdx.x; i < D3; i += blockDim.x) box[i] = T(0);
  for (size_t i = threadIdx.x; i < 6 * D2; i += blockDim.x) sc[i] = T(0);
  __syncthreads();
  for (int p = threadIdx.x; p < 6; p += blockDim.x)   // face x sign
    sc[p * D2 + size_t(c) * Dc + c] = src_cd;
  __syncthreads();

  for (int r = 1; r < R1; ++r) {
    Shell S;
    S.r = r; S.c = c; S.Dc = Dc;
    S.alo = c - r + 1; S.ahi = c + r - 1;
    S.ok_lo = c - r >= 0; S.ok_hi = c + r <= Dc - 1;
    const T* prev = sc + ((r - 1) & 1) * 6 * D2;
    T* cur = sc + (r & 1) * 6 * D2;
    const T *Xp = prev, *Yp = prev + 2 * D2, *Zp = prev + 4 * D2;
    T *Xn = cur, *Yn = cur + 2 * D2, *Zn = cur + 4 * D2;
    face_step<T, 0>(S, nhi, sw, path, diag, mask_m, mask_p, Xp, Yp, Zp, Xn,
                    box, R1, dr, sig);
    __syncthreads();
    face_step<T, 1>(S, nhi, sw, path, diag, mask_m, mask_p, Yp, Zp, Xn, Yn,
                    box, R1, dr, sig);
    __syncthreads();
    face_step<T, 2>(S, nhi, sw, path, diag, mask_m, mask_p, Zp, Xn, Yn, Zn,
                    box, R1, dr, sig);
    __syncthreads();
  }
  if (threadIdx.x == 0) box[c * D2 + size_t(c) * Dc + c] = src_cd;
}

template <typename T>
int launch(const void* nhi, const void* sw, const void* path, const void* diag,
           const void* mask_m, const void* mask_p, void* box, void* scratch,
           int B, int Dc, int c, int R1, double dr, double sig, int threads,
           void* stream) {
  cheb_sweep_kernel<T><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(nhi), static_cast<const T*>(sw),
      static_cast<const T*>(path), static_cast<const T*>(diag),
      static_cast<const uint8_t*>(mask_m), static_cast<const uint8_t*>(mask_p),
      static_cast<T*>(box), static_cast<T*>(scratch), Dc, c, R1,
      static_cast<T>(dr), static_cast<T>(sig));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch.
int cheb_sweep_f32(const void* nhi, const void* sw, const void* path,
                   const void* diag, const void* mask_m, const void* mask_p,
                   void* box, void* scratch, int B, int Dc, int c, int R1,
                   double dr, double sig, int threads, void* stream) {
  return launch<float>(nhi, sw, path, diag, mask_m, mask_p, box, scratch, B,
                       Dc, c, R1, dr, sig, threads, stream);
}

int cheb_sweep_f64(const void* nhi, const void* sw, const void* path,
                   const void* diag, const void* mask_m, const void* mask_p,
                   void* box, void* scratch, int B, int Dc, int c, int R1,
                   double dr, double sig, int threads, void* stream) {
  return launch<double>(nhi, sw, path, diag, mask_m, mask_p, box, scratch, B,
                        Dc, c, R1, dr, sig, threads, stream);
}

const char* cheb_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
