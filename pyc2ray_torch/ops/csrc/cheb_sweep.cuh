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
// handed to the sweep, so the sweep itself is written once. A valid face
// cell lies inside the box, at its cartesian position
// (x face -> [c-+r, a, b], y -> [a, c-+r, b], z -> [a, b, c-+r]); face
// memberships are disjoint, so every box cell is stored at most once.
//
// How the sweep is laid onto the card (struct Sweep):
//   - A thread-block cluster of C = 2^lgC blocks works on one source. The
//     3 (R1 - 1) sub-steps depend on each other, so between two of them
//     stands one hardware cluster barrier (arrive after the sub-step's
//     stores, wait before the next sub-step's loads); its release/acquire
//     orders the plane and box stores of all blocks.
//   - A sub-step of shell r visits only the shell's window, a, b in
//     [max(c-r, 0), min(c+r, Dc-1)], both signs: the masks are false outside
//     it. The window's 2 W^2 cells are dealt out evenly, block `rank` taking
//     cells [rank n/C, (rank+1) n/C). Cells outside a window are never
//     stored, so all 12 planes start as zeros.
//   - The X/Y/Z planes of shells r-1 and r (12 planes: parity r & 1, face,
//     sign) live either in the cluster's distributed shared memory, row a of
//     every plane in the block a mod C (Plan::rows > 0), or, where that does
//     not fit, in a global scratch read and written through L2. The stitches
//     read transposed positions, so most reads go to another block.
//   - The seven operands of a cell that do not depend on the chain (four
//     corner weights, diag, path, nHI) are loaded where they are used: their
//     loads overlap the stencil reads, and a cp.async stage that fetched
//     them two sub-steps ahead was slower on the H100 (PERF.md).
// The placement is a rule of (B, Dc, dtype) computed on the host
// (ops/sweep.py::sweep_plan) and checked by the launch code here.
//
// All arithmetic uses the explicitly rounded intrinsics (no FMA
// contraction), so every operation rounds as in the plain PyTorch version.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cheb {

namespace cg = cooperative_groups;

constexpr double kFourPi = 12.566370614359172463991853874177;
constexpr double kMaxColdensH = 2.0e30;   // rates are zeroed above this cdin
constexpr int kOperands = 7;              // chain-independent operands of a cell

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

// The two halves of the cluster barrier (release on arrive, acquire on
// wait). Every thread of every block of the cluster executes both.
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

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

// How a launch lays the sweep onto the card (ops/sweep.py::sweep_plan).
struct Plan {
  int lgC;      // a cluster of 1 << lgC blocks per source
  int rows;     // plane rows per block in shared memory, ceil(Dc / C); 0: the
                // planes live in the global scratch
  int head;     // values of T at the start of dynamic shared memory that
                // belong to the kernel (the spectral bins)
};

// Per-shell constants shared by the three sub-steps.
struct Shell {
  int r, c, Dc;
  int alo, ahi;        // c -+ (r-1): the stitched lines of the r-1 planes
  int qlo, qhi;        // the same, clamped into the box (a line outside it
                       // is read only by cells whose whole face is masked)
  int lo, hi;          // the window, and the clamped nHI planes c -+ r
  bool ok_lo, ok_hi;   // c -+ r inside the box
  int pv, cu;          // first plane of parity (r-1) & 1 and of r & 1
  __device__ int pos(int s) const { return s ? qhi : qlo; }
};

__device__ __forceinline__ Shell make_shell(int r, int c, int Dc) {
  Shell S;
  S.r = r; S.c = c; S.Dc = Dc;
  S.alo = c - r + 1; S.ahi = c + r - 1;
  S.qlo = max(S.alo, 0); S.qhi = min(S.ahi, Dc - 1);
  S.lo = max(c - r, 0); S.hi = min(c + r, Dc - 1);
  S.ok_lo = c - r >= 0; S.ok_hi = c + r <= Dc - 1;
  S.pv = ((r - 1) & 1) * 6; S.cu = (r & 1) * 6;
  return S;
}

// A block's share [i0, i1) of the 2 W^2 window cells of a shell; cell i is
// (sign, a, b) = (i / W^2, lo + (i % W^2) / W, lo + i % W).
struct Share {
  int lo, W, W2, i0, i1;
  __device__ void cell(int i, int& s, int& a, int& b) const {
    s = i >= W2;
    const int rem = i - s * W2, ra = rem / W;
    a = lo + ra;
    b = lo + rem - ra * W;
  }
};

// A valid face cell handed to a Store: its cartesian offset in the box and
// its values.
template <typename T>
struct FaceCell {
  size_t o;
  T cdin, dcol, nhi, path, out;
};

// Dynamic shared memory as an array of T (one extern declaration for all
// instantiations).
template <typename T>
__device__ T* shared_mem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// The sweep of one source by one cluster. SH: the planes live in the
// cluster's distributed shared memory (else in the global scratch `sc`).
template <typename T, bool SH>
struct Sweep {
  Tables<T> tb;
  const T* nhi;      // the source's (Dc, Dc, Dc) box
  T* planes;         // SH: this block's rows, [12][rows][Dc] in shared
                     // memory; else the source's [12][Dc][Dc] scratch
  int lgC, rows;
  unsigned rank;     // of this block in its cluster

  __device__ Sweep(const Tables<T>& tb_, const Plan& pl, const T* nhi_, T* sc)
      : tb(tb_), nhi(nhi_), lgC(pl.lgC), rows(pl.rows),
        rank(cg::this_cluster().block_rank()) {
    planes = SH ? shared_mem<T>() + pl.head : sc;
  }

  // Cell (a, b) of plane p = parity * 6 + face * 2 + sign.
  __device__ __forceinline__ T* at(int p, int a, int b) const {
    if (SH) {
      T* mine = planes + (size_t(p) * rows + (a >> lgC)) * tb.Dc + b;
      return cg::this_cluster().map_shared_rank(mine, a & ((1 << lgC) - 1));
    }
    return planes + (size_t(p) * tb.Dc + a) * tb.Dc + b;
  }
  // Planes in global memory are written by other SMs: go through L2.
  __device__ __forceinline__ T ld(int p, int a, int b) const {
    return SH ? *at(p, a, b) : __ldcg(at(p, a, b));
  }
  __device__ __forceinline__ void st(int p, int a, int b, T v) const {
    if (SH) *at(p, a, b) = v; else __stcg(at(p, a, b), v);
  }

  __device__ Share share(const Shell& S) const {
    Share w;
    w.lo = S.lo; w.W = S.hi - S.lo + 1; w.W2 = w.W * w.W;
    const int n = 2 * w.W2, per = (n + (1 << lgC) - 1) >> lgC;
    w.i0 = min(int(rank) * per, n);
    w.i1 = min(w.i0 + per, n);
    return w;
  }

  // The stitched stencil plane of face F at (s, a, b). x faces: X[r-1];
  // rows j = alo/ahi from Y[r-1]; cols k = alo/ahi from Z[r-1]. y faces:
  // Y[r-1]; cols k = alo/ahi from Z[r-1]; rows i = c-+r from X[r]. z faces:
  // Z[r-1]; rows i = c-+r from X[r]; cols j = c-+r from Y[r]. Later writes
  // of the reference win, hence the order of the tests.
  template <int F>
  __device__ __forceinline__ T stencil(const Shell& S, int s, int a, int b) const {
    const int q = S.pos(s);
    if (F == 0) {
      if (b == S.ahi) return ld(S.pv + 5, q, a);
      if (b == S.alo) return ld(S.pv + 4, q, a);
      if (a == S.ahi) return ld(S.pv + 3, q, b);
      if (a == S.alo) return ld(S.pv + 2, q, b);
      return ld(S.pv + s, a, b);
    } else if (F == 1) {
      if (S.ok_hi && a == S.c + S.r) return ld(S.cu + 1, q, b);
      if (S.ok_lo && a == S.c - S.r) return ld(S.cu + 0, q, b);
      if (b == S.ahi) return ld(S.pv + 5, a, q);
      if (b == S.alo) return ld(S.pv + 4, a, q);
      return ld(S.pv + 2 + s, a, b);
    } else {
      if (S.ok_hi && b == S.c + S.r) return ld(S.cu + 3, a, q);
      if (S.ok_lo && b == S.c - S.r) return ld(S.cu + 2, a, q);
      if (S.ok_hi && a == S.c + S.r) return ld(S.cu + 1, b, q);
      if (S.ok_lo && a == S.c - S.r) return ld(S.cu + 0, b, q);
      return ld(S.pv + 4 + s, a, b);
    }
  }

  // Address of operand k of face F's cell (s, a, b): 0-3 the corner
  // weights, 4 diag, 5 path, 6 the nHI of the cell's box position (the
  // plane c -+ r clamped into the box).
  template <int F>
  __device__ __forceinline__ const T* operand(const Shell& S, int k, int s,
                                              int a, int b) const {
    const size_t D = tb.Dc, D2 = D * D, ab = size_t(a) * D + b;
    if (k < 4)
      return tb.sw + ((size_t(F) * 4 + k) * tb.R1 + S.r) * D2 + ab;
    if (k == 4) return tb.diag + (size_t(F) * tb.R1 + S.r) * D2 + ab;
    if (k == 5) return tb.path + (size_t(F) * tb.R1 + S.r) * D2 + ab;
    const size_t plane = s ? S.hi : S.lo;
    if (F == 0) return nhi + plane * D2 + ab;
    if (F == 1) return nhi + size_t(a) * D2 + plane * D + b;
    return nhi + size_t(a) * D2 + size_t(b) * D + plane;
  }

  // This block's share of one face pair of shell S: face F (0 = x, 1 = y,
  // 2 = z). Writes the new (masked) plane cells and hands every valid cell
  // to `store`.
  template <int F, class Store>
  __device__ void face_step(const Shell& S, const Store& store) const {
    using A = Arith<T>;
    const int D = S.Dc;
    const size_t D2 = size_t(D) * D;
    const T lim = T(0.6);
    const Share w = share(S);
    const size_t g = (size_t(F) * tb.R1 + S.r) * D2;    // (f, r) plane offset
    for (int i = w.i0 + threadIdx.x; i < w.i1; i += blockDim.x) {
      int s, a, b;
      w.cell(i, s, a, b);
      const size_t ab = size_t(a) * D + b;
      const bool m = (s ? tb.mask_p : tb.mask_m)[g + ab] != 0;
      T op[kOperands];
#pragma unroll
      for (int k = 0; k < kOperands; ++k) op[k] = *operand<F>(S, k, s, a, b);
      const int a1 = a >= S.c ? max(a - 1, 0) : min(a + 1, D - 1);
      const int b1 = b >= S.c ? max(b - 1, 0) : min(b + 1, D - 1);
      const T P = stencil<F>(S, s, a, b);
      const T Pa = stencil<F>(S, s, a1, b);
      const T Pb = stencil<F>(S, s, a, b1);
      const T Pab = stencil<F>(S, s, a1, b1);
      const T w1 = A::div(op[0], max_lim(lim, A::mul(Pab, tb.sig)));
      const T w2 = A::div(op[1], max_lim(lim, A::mul(Pb, tb.sig)));
      const T w3 = A::div(op[2], max_lim(lim, A::mul(Pa, tb.sig)));
      const T w4 = A::div(op[3], max_lim(lim, A::mul(P, tb.sig)));
      T num = A::add(A::add(A::add(A::mul(Pab, w1), A::mul(Pb, w2)),
                            A::mul(Pa, w3)), A::mul(P, w4));
      T den = A::add(A::add(A::add(w1, w2), w3), w4);
      const T cdin = A::div(A::mul(op[4], num), den);
      const T dcol = A::mul(op[6], A::mul(op[5], tb.dr));
      const T v = m ? A::add(cdin, dcol) : T(0);
      st(S.cu + 2 * F + s, a, b, v);
      if (m) {                      // valid cells lie inside the box
        const int q = s ? S.c + S.r : S.c - S.r;
        size_t o;
        if (F == 0) o = size_t(q) * D2 + ab;
        else if (F == 1) o = size_t(a) * D2 + size_t(q) * D + b;
        else o = size_t(a) * D2 + size_t(b) * D + q;
        store(FaceCell<T>{o, cdin, dcol, op[6], op[5], v});
      }
    }
  }

  // Shells r0 .. r1-1 from the planes of shell r0-1, which every block has
  // written (init) but not yet published: the first barrier here does that,
  // and it orders any other store made before the call. After the return
  // the planes of shell r1-1 and all stores of `store` are visible to the
  // whole cluster, and no block touches another's shared memory again.
  template <class Store>
  __device__ void run(int r0, int r1, const Store& store) const {
    const int nsub = 3 * max(r1 - r0, 0);
    cluster_arrive();
    for (int n = 0; n < nsub; ++n) {
      const Shell S = make_shell(r0 + n / 3, tb.c, tb.Dc);
      const int f = n % 3;
      cluster_wait();
      if (f == 0) face_step<0>(S, store);
      else if (f == 1) face_step<1>(S, store);
      else face_step<2>(S, store);
      cluster_arrive();
    }
    cluster_wait();
  }

  // p[0 .. n) = 0, dealt out over the cluster's threads.
  __device__ void fill_zero(T* p, size_t n) const {
    const size_t step = size_t(blockDim.x) << lgC;
    for (size_t i = size_t(rank) * blockDim.x + threadIdx.x; i < n; i += step)
      p[i] = T(0);
  }

  // Value of plane cell (p, a, b) at the start: zero, but in parity `par`
  // the carried planes `carry` ([6][Dc][Dc], face x sign) or, without them,
  // shell 0's planes: the source cell of every face and sign at src_cd.
  __device__ T initial(int p, int a, int b, const T* carry, int par,
                       T src_cd) const {
    if (p / 6 != par) return T(0);
    if (carry) return carry[(size_t(p % 6) * tb.Dc + a) * tb.Dc + b];
    return a == tb.c && b == tb.c ? src_cd : T(0);
  }

  // Set all 12 planes (see initial). Every block writes only its own rows,
  // or its share of the scratch; run() publishes them.
  __device__ void init(const T* carry, int par, T src_cd) const {
    const int D = tb.Dc;
    if (SH) {
      for (int e = threadIdx.x; e < 12 * rows * D; e += blockDim.x) {
        const int a = (((e / D) % rows) << lgC) + int(rank);
        planes[e] = a < D ? initial(e / (rows * D), a, e % D, carry, par,
                                    src_cd) : T(0);
      }
    } else {
      const int step = blockDim.x << lgC;
      for (int e = rank * blockDim.x + threadIdx.x; e < 12 * D * D; e += step)
        planes[e] = initial(e / (D * D), (e / D) % D, e % D, carry, par,
                            src_cd);
    }
  }

  // The 6 planes of parity `par` to `out` ([6][Dc][Dc]), after run().
  __device__ void export_planes(T* out, int par) const {
    const int D = tb.Dc;
    if (SH) {
      for (int e = threadIdx.x; e < 6 * rows * D; e += blockDim.x) {
        const int p = e / (rows * D), b = e % D;
        const int a = (((e / D) % rows) << lgC) + int(rank);
        if (a < D)
          out[(size_t(p) * D + a) * D + b] = planes[size_t(par) * 6 * rows * D + e];
      }
    } else {
      const int step = blockDim.x << lgC;
      for (int e = rank * blockDim.x + threadIdx.x; e < 6 * D * D; e += step)
        out[e] = __ldcg(planes + size_t(par) * 6 * D * D + e);
    }
  }
};

// The source cell's outgoing column density nHI_c * dr / 2.
template <typename T>
__device__ T source_cd(const Tables<T>& tb, const T* nhi) {
  const size_t c = tb.c, D = tb.Dc;
  return Arith<T>::mul(nhi[(c * D + c) * D + c], Arith<T>::mul(T(0.5), tb.dr));
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
Tables<T> make_tables(const void* sw, const void* path, const void* diag,
                      const void* mask_m, const void* mask_p, int Dc, int c,
                      int R1, double dr, double sig) {
  return Tables<T>{static_cast<const T*>(sw), static_cast<const T*>(path),
                   static_cast<const T*>(diag),
                   static_cast<const uint8_t*>(mask_m),
                   static_cast<const uint8_t*>(mask_p), Dc, c, R1,
                   static_cast<T>(dr), static_cast<T>(sig)};
}

// What the caller decided (ops/sweep.py::sweep_plan) about one launch.
struct LaunchSpec {
  int B, threads;
  int cluster;         // blocks per source: 1, 2, 4, 8 or 16
  int shared_planes;   // planes in distributed shared memory (else scratch)
  int smem;            // dynamic shared memory per block, bytes
  int* max_clusters;   // not null: launch nothing, write here how many
                       // clusters of this launch the card holds at once
  void* stream;
};

// The Plan of `spec` for a sweep of (Dc, Dc, Dc) boxes with `head` values of T of the
// kernel's own at the start of shared memory. Fails where the caller's
// sizes are not the ones this code uses.
template <typename T>
cudaError_t make_plan(const LaunchSpec& spec, int Dc, int head, Plan* pl) {
  const int C = spec.cluster;
  int lgC = 0;
  while ((1 << lgC) < C) ++lgC;
  if (C < 1 || C > 16 || (1 << lgC) != C) return cudaErrorInvalidValue;
  pl->lgC = lgC;
  pl->rows = spec.shared_planes ? (Dc + C - 1) / C : 0;
  pl->head = head;
  const size_t smem = sizeof(T) * (size_t(head) + size_t(12) * pl->rows * Dc);
  return smem == size_t(spec.smem) ? cudaSuccess : cudaErrorInvalidValue;
}

// Allow `kernel` on the current device `smem` bytes of dynamic shared memory
// and, for more than 8 blocks, a cluster of non-portable size. An attribute
// is set only when a (device, kernel) pair needs more than it was given
// before, so a run of equal launches sets its attributes once.
inline cudaError_t allow(const void* kernel, int smem, bool big_cluster) {
  struct Given { int smem; bool big_cluster; };
  static std::mutex lock;
  static std::map<std::pair<int, const void*>, Given> given;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(lock);
  Given& g = given.try_emplace({dev, kernel}, Given{0, false}).first->second;
  if (smem > g.smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    g.smem = smem;
  }
  if (big_cluster && !g.big_cluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g.big_cluster = true;
  }
  return cudaSuccess;
}

// Launch `kernel` as spec.B clusters of spec.cluster blocks (or, with
// spec.max_clusters, only ask how many of them fit). Returns the first
// error; a refused launch never runs.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), const LaunchSpec& spec,
                   Args... args) {
  cudaError_t err = allow(reinterpret_cast<const void*>(kernel), spec.smem,
                          spec.cluster > 8);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(spec.B * spec.cluster);
  cfg.blockDim = dim3(spec.threads);
  cfg.dynamicSmemBytes = spec.smem;
  cfg.stream = static_cast<cudaStream_t>(spec.stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = spec.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (spec.max_clusters != nullptr)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(spec.max_clusters, kernel, &cfg));
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace cheb
