// The chemistry passes on NVIDIA Hopper (sm_90a): the hydrogen pass
// (global_pass) and the coupled hydrogen + helium pass (global_pass_he),
// each one kernel launch; a cell's iterations run in one thread.
//
// Counterpart of the JAX package's jitted lax.while_loop of
// pyc2ray_tpu/ops/chemistry.py::global_pass (:84-123) and
// pyc2ray_tpu/ops/chemistry_he.py::global_pass_he (:294, :406), which XLA
// runs on the device as one program per pass. No TPU kernel of its own.
// Plain versions: pyc2ray_torch/ops/chemistry.py::global_pass_ref and
// ops/chemistry_he.py::global_pass_he_ref, the masked dense loops that read
// one stop flag back to the host per inner iteration.
//
//   hydrogen_pass_kernel  doric on n_e = n_H (<x> + abu_c) until <x> of the
//                         cell converges or the cap is reached; then the
//                         cell's vote in the non-convergence count. A
//                         thread takes two consecutive cells of each
//                         field at a time.
//   helium_pass_kernel    the same for the three species: doric, the
//                         secondary-ionisation channel (HEAT), on-the-spot
//                         recombination photons (REC), the helium pair's
//                         2x2 solve in double and the three-way test.
//
// Why a thread per cell is the dense loop. A cell's iterations read only
// that cell. In the plain loop a cell that is still active at iteration k
// has been updated k times, and a frozen cell never changes. So running
// each cell to its own convergence or to the cap leaves every cell where
// the dense loop leaves it, and the kernel needs no host test.
//
// Rounding. Every operation is the one the plain version issues on the
// card, in its order and its type: the explicitly rounded intrinsics (no
// FMA contraction); a Python scalar rounded to the tensor's type before the
// operation; a division by a Python scalar as a multiply by its reciprocal
// in that type (ATen's div_true with a CPU scalar); a scalar over a tensor
// as the tensor's reciprocal times the scalar (Tensor.__rtruediv__); pow,
// exp, expm1 and sqrt as the same CUDA math functions; clamp, where and
// maximum with ATen's NaN rules. Terms that depend only on the temperature
// are computed once per cell: the plain loop recomputes the same bits in
// every iteration. So the results equal the plain pass's bit for bit.
//
// The count. Each thread counts the not-converged cells of its stride; a
// warp adds its lanes' counts (__reduce_add_sync), the block its warps' in
// shared memory, and adds the sum to the 64-bit counter with one
// atomicAdd. Integer adds do not depend on order.
//
// The hydrogen pass on this card (its function is bound by its bytes at
// ~0.11 ms for 250^3 float32 cells, its arithmetic well below them): a
// thread loads its two cells with one 8- or 16-byte load per field (in
// float32 a trip ahead) and stores them with streaming stores of the same
// width, so the index arithmetic is paid once for both; it reuses the
// temperature rates (a pow, a sqrt, an exp, a division) while its cells'
// temperatures hold the same bits, as they do in an isothermal run; doric's
// float32 series and the time average (1 - e^-z)/z are evaluated only where
// the closed form reads them. The grid is persistent (the blocks the card
// holds at once, each warp striding over groups of 32 threads' cells), the
// warp gathered after each of a thread's cells, and the registers capped
// at 64 (kHydrogenBlocks): where a few cells iterate long (a temperature
// of its own in every cell) the warps that finished take new cells instead
// of holding their block's slot. The operations that run are the ones the
// plain pass issues, so the bits are the same.
//
// Bound. A pass reads five fields (nine for helium, ten with heat) and
// writes two (six), once: 0.44 GB for 250^3 float32 cells, 0.13 ms at
// 3.35 TB/s. Each cell then iterates a few to a few hundred times, with
// two to six transcendentals an iteration, so the pass is bound by the
// iterations of its slowest cells. The kernel keeps a cell's state in
// registers for all of them.
//
// Latency. The helium pass's iteration is long float64 chains (its 2x2
// solve is float64 in either type): its instructions need a quarter to a
// half of the time it takes at the issue rate, and less on the float64
// pipe (64 lanes a clock per SM) and the MUFU, with 80-110 registers a
// thread, two blocks of 256 to an SM. So it caps its registers
// (he_min_blocks): three or four blocks to an SM, some of a cell's state
// spilled to local memory, which L1 keeps, and more warps to hide the
// chains.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace chem {

constexpr int kThreads = 256;        // threads per block (a power of two)

#include "rounded.cuh"

// The pass's scalars, each rounded to T as the plain version rounds it.
// Host order of the doubles (ops/chemistry.py::_kernel_params): bh00,
// albpow, colh0, temph0, abu_c, clumping, EPSILON, the two convergence
// thresholds, the float32 series' bound and its ten coefficients.
constexpr int kHParams = 20;
template <typename T>
struct HConst {
  T cb;            // clumping * bh00
  T inv_1e4;       // 1 / 1e4 (temp / 1e4)
  T albpow, colh0;
  T neg_temph0;    // -temph0 (-temph0 / temp)
  T abu_c, eps, min_change, min_atoms, series_below;
  T g[10];         // g(z) = sum g[k] z^(k+1)
};

template <typename T>
HConst<T> h_const(const double* p) {
  HConst<T> k;
  k.cb = static_cast<T>(p[5] * p[0]);
  k.inv_1e4 = static_cast<T>(1.0) / static_cast<T>(1.0e4);
  k.albpow = static_cast<T>(p[1]);
  k.colh0 = static_cast<T>(p[2]);
  k.neg_temph0 = static_cast<T>(-p[3]);
  k.abu_c = static_cast<T>(p[4]);
  k.eps = static_cast<T>(p[6]);
  k.min_change = static_cast<T>(p[7]);
  k.min_atoms = static_cast<T>(p[8]);
  k.series_below = static_cast<T>(p[9]);
  for (int i = 0; i < 10; ++i) k.g[i] = static_cast<T>(p[10 + i]);
  return k;
}

// The rates of a cell that depend only on its temperature (doric's).
template <typename T>
struct HCell {
  T brech0;        // clumping * bh00 (T / 1e4)^albpow
  T acolh0;        // colh0 sqrt(T) exp(-temph0 / T)
};

template <typename T>
__device__ __forceinline__ HCell<T> h_cell(T temp, const HConst<T>& k) {
  HCell<T> c;
  c.brech0 = mul(pow_(mul(temp, k.inv_1e4), k.albpow), k.cb);
  c.acolh0 = mul(mul(sqrt_(temp), k.colh0),
                 exp_(mul(div(T(1), temp), k.neg_temph0)));
  return c;
}

// doric's closed form: float64 the reference's expression
// (_closed_form_reference), float32 the cancellation-free form
// (_closed_form_float32).
__device__ __forceinline__ void closed_form(double x0, double eqxh,
                                            double z, const HConst<double>&,
                                            double* x, double* xav) {
  const double ee = exp_(-z);
  *x = add(mul(sub(x0, eqxh), ee), eqxh);
  const double avg = z < 1.0e-8 ? 1.0 : div(sub(1.0, ee), z);
  *xav = add(eqxh, mul(sub(x0, eqxh), avg));
}

// The plain pass evaluates the series and (1 - e^-z)/z in every cell and
// selects; here each is evaluated where it is selected, with the same
// operations.
__device__ __forceinline__ void closed_form(float x0, float eqxh, float z,
                                            const HConst<float>& k, float* x,
                                            float* xav) {
  const float one_minus_ee = -expm1_(-z);
  const bool tiny = z < static_cast<float>(1.0e-8);
  const float d = sub(eqxh, x0);
  if (d >= 0.0f) {
    float g;
    if (tiny) {
      g = 0.0f;
    } else if (z < k.series_below) {
      g = k.g[9];
      for (int i = 8; i >= 0; --i) g = add(mul(z, g), k.g[i]);
      g = mul(z, g);
    } else {
      g = sub(1.0f, div(one_minus_ee, z));
    }
    *x = add(x0, mul(d, one_minus_ee));
    *xav = add(x0, mul(d, g));
  } else {
    const float avg = tiny ? 1.0f : div(one_minus_ee, z);
    *x = sub(eqxh, mul(d, exp_(-z)));
    *xav = sub(eqxh, mul(d, avg));
  }
}

// ops/chemistry.py::doric at electron density rhe and rate phi.
template <typename T>
__device__ __forceinline__ void doric(T x0, T dt, T rhe, T phi,
                                      const HCell<T>& c, const HConst<T>& k,
                                      T* x, T* xav) {
  const T aih0 = add(phi, mul(rhe, c.acolh0));
  const T delth = add(aih0, mul(rhe, c.brech0));
  const T eqxh = div(aih0, delth);
  closed_form(x0, eqxh, mul(delth, dt), k, x, xav);
  *x = clamp_min(*x, k.eps);
  *xav = clamp_min(*xav, k.eps);
}

// The cell's vote in the non-convergence count (chemistry.f90:99-104).
template <typename T>
__device__ __forceinline__ bool not_converged(T xav, T xav_entry,
                                              const HConst<T>& k) {
  const T yh = sub(T(1), xav_entry);
  const T delta = sub(xav, xav_entry);
  return abs_(delta) > k.min_change && abs_(div(delta, yh)) > k.min_change &&
         yh > k.min_atoms;
}

// A warp adds its lanes' counts, the block its warps' sums in shared
// memory (one word a warp); thread 0 adds the block's sum to the counter.
// Every thread of the block calls it; blockDim.x is a multiple of 32.
__device__ __forceinline__ void count_block(unsigned n,
                                            unsigned long long* count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* part = reinterpret_cast<unsigned*>(smem_raw);
  const unsigned t = threadIdx.x;
  n = __reduce_add_sync(0xffffffffu, n);
  if (t % 32 == 0) part[t / 32] = n;
  __syncthreads();
  if (t == 0) {
    unsigned sum = 0;
    for (unsigned w = 0; w < blockDim.x / 32; ++w) sum += part[w];
    if (sum != 0) atomicAdd(count, static_cast<unsigned long long>(sum));
  }
}

// A thread's cells of a field: two, loaded as one vector of T. Four
// float32 cells a thread (16-byte loads) took 62 registers and were 6 %
// slower where every cell has its own temperature (PERF.md).
constexpr int kCells = 2;
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T>
__device__ __forceinline__ bool aligned(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) % sizeof(typename Pair<T>::type)) ==
         0;
}

// A thread's cells i0, i0 + 1 of field p: one vector load where both are
// below n and `vec` (every pointer of the pass aligned to the vector),
// else one load a cell below n (0 past it).
template <typename T>
__device__ __forceinline__ void load_cells(const T* p, long long i0,
                                           long long n, bool vec,
                                           T (&v)[kCells]) {
  using V = typename Pair<T>::type;
  if (vec && i0 + kCells <= n) {
    const V u = *reinterpret_cast<const V*>(p + i0);
    memcpy(v, &u, sizeof(u));
  } else {
    for (int j = 0; j < kCells; ++j) v[j] = i0 + j < n ? p[i0 + j] : T(0);
  }
}

// The same cells written, with a streaming vector store where both are.
template <typename T>
__device__ __forceinline__ void store_cells(T* p, long long i0, long long n,
                                            bool vec, const T (&v)[kCells]) {
  using V = typename Pair<T>::type;
  if (vec && i0 + kCells <= n) {
    V u;
    memcpy(&u, v, sizeof(u));
    __stcs(reinterpret_cast<V*>(p + i0), u);
  } else {
    for (int j = 0; j < kCells && i0 + j < n; ++j) p[i0 + j] = v[j];
  }
}

// The five fields of a thread's cells.
template <typename T>
struct CellFields {
  T nd[kCells], tp[kCells], x0[kCells], xe[kCells], ph[kCells];
};

template <typename T, typename Args>
__device__ __forceinline__ void load_fields(const Args& a, long long i0,
                                            bool vec, CellFields<T>* f) {
  load_cells(a.ndens, i0, a.n, vec, f->nd);
  load_cells(a.temp, i0, a.n, vec, f->tp);
  load_cells(a.xh, i0, a.n, vec, f->x0);
  load_cells(a.xh_av, i0, a.n, vec, f->xe);
  load_cells(a.phi, i0, a.n, vec, f->ph);
}

template <typename T>
__device__ __forceinline__ bool same_bits(T a, T b) {
  using U = typename std::conditional<sizeof(T) == 8, unsigned long long,
                                      unsigned>::type;
  U ua, ub;
  memcpy(&ua, &a, sizeof(T));
  memcpy(&ub, &b, sizeof(T));
  return ua == ub;
}

template <typename T>
struct HArgs {
  const T *ndens, *temp, *xh, *xh_av, *phi;
  const bool* mask;               // null: every cell counts
  T *xh_out, *xh_av_out;
  unsigned long long* count;
  int* iters;                     // null, or the iterations of every cell
  long long n;
  int cap;
  Dt dt;
  HConst<T> k;
};

// Blocks of kThreads an SM that the hydrogen kernel's registers must allow
// (64 registers a thread): without the cap its float64 form takes 68, three
// blocks an SM, and is 12 % slower (PERF.md).
constexpr int kHydrogenBlocks = 4;

// A thread takes kCells consecutive cells at a time, a warp 32 such
// groups, striding over the grid's warps (a persistent grid: as many
// blocks as the card holds at once, so a warp whose cells converged early
// takes its next ones without waiting for the rest of its block). A
// thread's cells iterate one after the other, each to its own convergence
// or the cap, the warp's lanes gathered again after each (__syncwarp: a
// lane whose cell converged early waits for the others instead of starting
// its next cell's rates alone), and the temperature's rates are computed
// again only where a cell's temperature differs in its bits from the last
// one's. In float32 a thread loads its next trip's cells before it
// iterates this trip's, so their latency hides behind this trip's work;
// float64 loads each trip's at its start (its registers leave no room for
// a second set: with it 64 registers spill and the pass takes 0.41 ms on
// the EoR state where it takes 0.30, PERF.md).
template <typename T>
__global__ void __launch_bounds__(kThreads, kHydrogenBlocks)
    hydrogen_pass_kernel(HArgs<T> a) {
  constexpr int K = kCells;
  const HConst<T>& k = a.k;
  const T dt = static_cast<T>(a.dt.read());
  const bool vec = aligned(a.ndens) && aligned(a.temp) && aligned(a.xh) &&
                   aligned(a.xh_av) && aligned(a.phi) && aligned(a.xh_out) &&
                   aligned(a.xh_av_out);
  unsigned n_not = 0;
  HCell<T> c{};
  T t_last{};
  bool have_cell = false;
  const unsigned lane = threadIdx.x % 32;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x * K;
  // the warp's first cell: the same in all its lanes, so that every lane
  // takes the loop's trips and reaches each __syncwarp
  const long long w_first =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x - lane) *
      K;
  constexpr bool kAhead = sizeof(T) == 4;
  CellFields<T> f, next;
  if (kAhead) load_fields(a, w_first + lane * K, vec, &f);
  for (long long w0 = w_first; w0 < a.n; w0 += stride) {
    const long long i0 = w0 + static_cast<long long>(lane) * K;
    if (kAhead)
      load_fields(a, i0 + stride, vec, &next);
    else
      load_fields(a, i0, vec, &f);
    const T(&nd)[K] = f.nd;
    const T(&tp)[K] = f.tp;
    const T(&x0)[K] = f.x0;
    const T(&xe)[K] = f.xe;
    const T(&ph)[K] = f.ph;
    T xo[K], xao[K];
    for (int j = 0; j < K; ++j) {
      __syncwarp();
      if (i0 + j >= a.n) continue;
      if (!have_cell || !same_bits(tp[j], t_last)) {
        c = h_cell(tp[j], k);
        t_last = tp[j];
        have_cell = true;
      }
      T xav = xe[j], xint = x0[j];
      int it = 0;
      while (it < a.cap) {
        T x, av;
        doric(x0[j], dt, mul(nd[j], add(xav, k.abu_c)), ph[j], c, k, &x,
              &av);
        const T rel = abs_(div(sub(av, xav), sub(T(1), av)));
        const bool done = rel < k.min_change || sub(T(1), av) < k.min_atoms;
        xav = av;
        xint = x;
        ++it;
        if (done) break;
      }
      xo[j] = xint;
      xao[j] = xav;
      if (a.iters != nullptr) a.iters[i0 + j] = it;
      n_not += not_converged(xav, xe[j], k) &&
               (a.mask == nullptr || a.mask[i0 + j]);
    }
    store_cells(a.xh_out, i0, a.n, vec, xo);
    store_cells(a.xh_av_out, i0, a.n, vec, xao);
    if (kAhead) f = next;
  }
  count_block(n_not, a.count);
}

// Helium: the doubles of the host (ops/chemistry_he.py::_kernel_params)
// after the kHParams hydrogen ones: abu_he, bhe00, alhepow, colhe0,
// temphe0, colhe1, temphe1, the four recycling cross sections, the two SvS
// ramps, the HI and HeI thresholds in erg (heat / E_th), 2 bh00, the cap of
// dep/n_HeI (1e12 E_th(HeI)), 1 - EPSILON and the floor `tiny`.
template <typename T>
struct HeConst {
  HConst<T> h;
  T abu_he, bhe00, alhepow, colhe0, neg_temphe0, colhe1, neg_temphe1;
  T sig_h_he1, sig_he1_he1, sig_h_lya2, sig_he1_lya2, ramp_hi, ramp_hei;
  T inv_eth0, inv_eth1;            // 1 / E_th (heat / E_th)
  T bh00_2, dep_cap, one_minus_eps, tiny, clumping;
  T inv_1e5, inv_4e4;
  bool helium;                     // abu_he > 0: y1, y2 gate the iteration
};

template <typename T>
HeConst<T> he_const(const double* p) {
  HeConst<T> k;
  k.h = h_const<T>(p);
  const double* q = p + kHParams;
  k.abu_he = static_cast<T>(q[0]);
  k.bhe00 = static_cast<T>(q[1]);
  k.alhepow = static_cast<T>(q[2]);
  k.colhe0 = static_cast<T>(q[3]);
  k.neg_temphe0 = static_cast<T>(-q[4]);
  k.colhe1 = static_cast<T>(q[5]);
  k.neg_temphe1 = static_cast<T>(-q[6]);
  k.sig_h_he1 = static_cast<T>(q[7]);
  k.sig_he1_he1 = static_cast<T>(q[8]);
  k.sig_h_lya2 = static_cast<T>(q[9]);
  k.sig_he1_lya2 = static_cast<T>(q[10]);
  k.ramp_hi = static_cast<T>(q[11]);
  k.ramp_hei = static_cast<T>(q[12]);
  k.inv_eth0 = static_cast<T>(1.0) / static_cast<T>(q[13]);
  k.inv_eth1 = static_cast<T>(1.0) / static_cast<T>(q[14]);
  k.bh00_2 = static_cast<T>(q[15]);
  k.dep_cap = static_cast<T>(q[16]);
  k.one_minus_eps = static_cast<T>(q[17]);
  k.tiny = static_cast<T>(q[18]);
  k.clumping = static_cast<T>(p[5]);
  k.inv_1e5 = static_cast<T>(1.0) / static_cast<T>(1.0e5);
  k.inv_4e4 = static_cast<T>(1.0) / static_cast<T>(4.0e4);
  k.helium = q[0] > 0.0;
  return k;
}

// The helium rates of a cell that depend only on its temperature
// (he_update's, and the recycling's a2, a3).
template <typename T>
struct HeCell {
  HCell<T> h;
  T c1, c2, a2, a3;
};

template <typename T>
__device__ __forceinline__ HeCell<T> he_cell(T temp, const HeConst<T>& k) {
  HeCell<T> c;
  c.h = h_cell(temp, k.h);
  const T sq = sqrt_(temp);
  const T damp = div(T(1), add(sqrt_(mul(temp, k.inv_1e5)), T(1)));
  const T rt = div(T(1), temp);
  c.c1 = mul(mul(mul(sq, k.colhe0), exp_(mul(rt, k.neg_temphe0))), damp);
  c.c2 = mul(mul(mul(sq, k.colhe1), exp_(mul(rt, k.neg_temphe1))), damp);
  c.a2 = mul(mul(pow_(mul(temp, k.h.inv_1e4), k.alhepow), k.bhe00),
             k.clumping);
  c.a3 = mul(mul(pow_(mul(temp, k.inv_4e4), k.h.albpow), k.bh00_2),
             k.clumping);
  return c;
}

// phi1(z) = (e^z - 1)/z and phi2(z) = (e^z - 1 - z)/z^2, by their series
// for small z (_expm2's phi1, phi2).
__device__ __forceinline__ double phi1(double z) {
  if (abs_(z) < 1e-6)
    return add(add(mul(z, 0.5), 1.0), mul(mul(z, z), 1.0 / 6.0));
  return div(expm1_(z), z);
}
__device__ __forceinline__ double phi2(double z) {
  if (abs_(z) < 1e-4)
    return add(add(mul(z, 1.0 / 6.0), 0.5), mul(mul(z, z), 1.0 / 24.0));
  return div(sub(expm1_(z), z), mul(z, z));
}

// The 2x2 system of _expm2 in double, with the divided-difference form
// f(z2) I + [f(z1) - f(z2)]/(z1 - z2) (At - z2 I) of each matrix function.
struct Expm2 {
  double A11, A12, A21, A22, dt, z2, inv_sep;
  __device__ void apply(double f1, double f2, double v1, double v2,
                        double* o1, double* o2) const {
    const double dd = mul(sub(f1, f2), inv_sep);
    const double w1 =
        add(mul(sub(mul(A11, dt), z2), v1), mul(mul(A12, dt), v2));
    const double w2 =
        add(mul(mul(A21, dt), v1), mul(sub(mul(A22, dt), z2), v2));
    *o1 = add(mul(f2, v1), mul(dd, w1));
    *o2 = add(mul(f2, v2), mul(dd, w2));
  }
};

// u(dt) and <u> of du/dt = A u + (b1, 0) from u = (u1, u2) (_expm2).
__device__ __forceinline__ void expm2(double A11, double A12, double A21,
                                      double A22, double b1, double u1,
                                      double u2, double dt, double* ut1,
                                      double* ut2, double* ua1, double* ua2) {
  const double b2 = 0.0;
  const double tr = add(A11, A22);
  const double det = sub(mul(A11, A22), mul(A12, A21));
  double disc = sqrt_(clamp_min(sub(mul(tr, tr), mul(det, 4.0)), 0.0));
  const double scale =
      add(add(add(abs_(tr), abs_(A12)), abs_(A21)), 1e-290);
  disc = maximum(disc, mul(scale, 1.4901161193847656e-08));  // sqrt(eps)
  const double l1 = clamp_max(mul(add(tr, disc), 0.5), 0.0);
  const double l2 = mul(sub(tr, disc), 0.5);
  const double z1 = mul(l1, dt), z2 = mul(l2, dt);
  const Expm2 m{A11, A12, A21, A22, dt, z2, div(1.0, mul(sub(l1, l2), dt))};
  double eu1, eu2, pb1, pb2, pu1, pu2, qb1, qb2;
  const double p1 = phi1(z1), p2 = phi1(z2);
  m.apply(exp_(z1), exp_(z2), u1, u2, &eu1, &eu2);
  m.apply(p1, p2, b1, b2, &pb1, &pb2);
  *ut1 = add(eu1, mul(pb1, dt));
  *ut2 = add(eu2, mul(pb2, dt));
  m.apply(p1, p2, u1, u2, &pu1, &pu2);
  m.apply(phi2(z1), phi2(z2), b1, b2, &qb1, &qb2);
  *ua1 = add(pu1, mul(qb1, dt));
  *ua2 = add(pu2, mul(qb2, dt));
}

// y1 into [EPSILON, 1], y2 into [0, 1], the pair scaled below 1 (_clamp_pair).
template <typename T>
__device__ __forceinline__ void clamp_pair(T* y1, T* y2, const HeConst<T>& k) {
  *y1 = clamp(*y1, k.h.eps, T(1));
  *y2 = clamp(*y2, T(0), T(1));
  const T tot = add(*y1, *y2);
  const T scale = tot > T(1) ? mul(div(T(1), tot), k.one_minus_eps) : T(1);
  *y1 = mul(*y1, scale);
  *y2 = mul(*y2, scale);
}

// he_update: the frozen-rate helium update, the 2x2 solve in double.
template <typename T>
__device__ __forceinline__ void he_update(T y1, T y2, double dtw, T ne,
                                          T g_he1, T g_he2, const HeCell<T>& c,
                                          const HeConst<T>& k, T* y1t, T* y2t,
                                          T* y1a, T* y2a) {
  const T G1 = add(g_he1, mul(ne, c.c1));
  const T G2 = add(g_he2, mul(ne, c.c2));
  const T R2 = mul(ne, c.a2);
  const T R3 = mul(ne, c.a3);
  double ut1, ut2, ua1, ua2;
  expm2(static_cast<double>(-add(add(G1, G2), R2)),
        static_cast<double>(add(-G1, R3)), static_cast<double>(G2),
        static_cast<double>(-R3), static_cast<double>(G1),
        static_cast<double>(y1), static_cast<double>(y2), dtw, &ut1, &ut2,
        &ua1, &ua2);
  *y1t = static_cast<T>(ut1);
  *y2t = static_cast<T>(ut2);
  *y1a = static_cast<T>(ua1);
  *y2a = static_cast<T>(ua2);
  clamp_pair(y1t, y2t, k);
  clamp_pair(y1a, y2a, k);
}

template <typename T>
struct HeArgs {
  const T *ndens, *temp, *xh, *xh_av, *y1, *y1_av, *y2, *y2_av;
  const T *phi_h, *phi_he1, *phi_he2, *heat;
  const bool* mask;
  T *xh_out, *xh_av_out, *y1_out, *y1_av_out, *y2_out, *y2_av_out;
  unsigned long long* count;
  int* iters;
  long long n;
  int cap;
  Dt dt;
  HeConst<T> k;
};

// The Shull & van Steenberg fraction C (1 - x^a)^b at clamped x.
template <typename T>
__device__ __forceinline__ T svs(T xc, double C, double a, double b) {
  return mul(pow_(sub(T(1), pow_(xc, static_cast<T>(a))), static_cast<T>(b)),
             static_cast<T>(C));
}

// Blocks of kThreads an SM that the helium kernel's registers must allow
// (64 registers a thread at 4, 80 at 3), per type and options: the fastest
// of 2, 3 and 4 on the card in each (PERF.md).
template <typename T, bool HEAT, bool REC>
constexpr int he_min_blocks() {
  return sizeof(T) == 8 && HEAT && REC ? 3 : 4;
}

template <typename T, bool HEAT, bool REC>
__global__ void __launch_bounds__(kThreads, he_min_blocks<T, HEAT, REC>())
    helium_pass_kernel(HeArgs<T> a) {
  const HeConst<T>& k = a.k;
  const HConst<T>& kh = k.h;
  const double dtw = a.dt.read();
  const T dt = static_cast<T>(dtw);
  unsigned n_not = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < a.n; i += stride) {
    const T nd = a.ndens[i], x0 = a.xh[i], xav_entry = a.xh_av[i];
    const T y1_0 = a.y1[i], y2_0 = a.y2[i];
    const T phi_h = a.phi_h[i], phi_he1 = a.phi_he1[i], phi_he2 = a.phi_he2[i];
    const HeCell<T> c = he_cell(a.temp[i], k);
    const T nhe = mul(nd, k.abu_he);
    T xav = xav_entry, xint = x0;
    T y1av = a.y1_av[i], y1int = y1_0, y2av = a.y2_av[i], y2int = y2_0;
    T heat = T(0), dep = T(0);
    if (HEAT) {
      // the deposition per HeI atom at entry, capped (outside the loop)
      heat = a.heat[i];
      const T nhi = mul(nd, sub(T(1), xav_entry));
      const T nhei = mul(nhe, sub(sub(T(1), y1av), y2av));
      dep = nhei > k.tiny ? div(mul(heat, nhi), clamp_min(nhei, k.tiny))
                          : T(0);
      dep = clamp_max(dep, k.dep_cap);
    }
    int it = 0;
    while (it < a.cap) {
      const T ne = add(mul(nd, add(xav, kh.abu_c)),
                       mul(nhe, add(y1av, mul(y2av, T(2)))));
      T ph = phi_h, phe1 = phi_he1;
      if (HEAT) {
        const T xc = clamp(xav, T(0), T(1));
        ph = add(phi_h, mul(mul(mul(svs(xc, 0.3908, 0.4092, 1.7592),
                                    k.ramp_hi), heat), k.inv_eth0));
        phe1 = add(phi_he1, mul(mul(mul(svs(xc, 0.0554, 0.4614, 1.6660),
                                        k.ramp_hei), dep), k.inv_eth1));
      }
      if (REC) {
        const T nhi_c = mul(nd, sub(T(1), xav));
        const T nhei_c = mul(nhe, sub(sub(T(1), y1av), y2av));
        const T rec2 = mul(mul(mul(ne, c.a2), nhe), y1av);
        const T rec3 = mul(mul(mul(ne, c.a3), nhe), y2av);
        const T wh = mul(nhi_c, k.sig_h_he1), whe = mul(nhei_c, k.sig_he1_he1);
        const T y_f = div(wh, clamp_min(add(wh, whe), k.tiny));
        const T wh2 = mul(nhi_c, k.sig_h_lya2);
        const T whe2 = mul(nhei_c, k.sig_he1_lya2);
        const T z_f = div(wh2, clamp_min(add(wh2, whe2), k.tiny));
        const T add_h = div(add(mul(y_f, rec2), mul(z_f, rec3)),
                            clamp_min(nhi_c, k.tiny));
        const T add_he = div(add(mul(sub(T(1), y_f), rec2),
                                 mul(sub(T(1), z_f), rec3)),
                             clamp_min(nhei_c, k.tiny));
        const T cap = static_cast<T>(1e12);
        ph = add(ph, clamp_max(nhi_c > k.tiny ? add_h : T(0), cap));
        phe1 = add(phe1, clamp_max(nhei_c > k.tiny ? add_he : T(0), cap));
      }
      T x, av, y1t, y2t, y1a, y2a;
      doric(x0, dt, ne, ph, c.h, kh, &x, &av);
      he_update(y1_0, y2_0, dtw, ne, phe1, phi_he2, c, k, &y1t, &y2t,
                &y1a, &y2a);
      const T floor = static_cast<T>(1e-10);
      const T relx = abs_(div(sub(av, xav), sub(T(1), av)));
      const T rel1 = div(abs_(sub(y1a, y1av)), clamp_min(y1a, floor));
      const T rel2 = div(abs_(sub(y2a, y2av)), clamp_min(y2a, floor));
      bool done = relx < kh.min_change || sub(T(1), av) < kh.min_atoms;
      if (k.helium) done = done && rel1 < kh.min_change && rel2 < kh.min_change;
      xav = av;
      xint = x;
      y1av = y1a;
      y1int = y1t;
      y2av = y2a;
      y2int = y2t;
      ++it;
      if (done) break;
    }
    a.xh_out[i] = xint;
    a.xh_av_out[i] = xav;
    a.y1_out[i] = y1int;
    a.y1_av_out[i] = y1av;
    a.y2_out[i] = y2int;
    a.y2_av_out[i] = y2av;
    if (a.iters != nullptr) a.iters[i] = it;
    n_not += not_converged(xav, xav_entry, kh) &&
             (a.mask == nullptr || a.mask[i]);
  }
  count_block(n_not, a.count);
}

// The launches of the two kernels

// Blocks of a launch over n cells, `per` cells a thread: beyond the
// grid's limit of 2^31 - 1 blocks each thread striding over several.
unsigned grid_for(long long n, int per = 1) {
  const long long t = (n + per - 1) / per;
  const long long g = (t + kThreads - 1) / kThreads;
  return static_cast<unsigned>(g < 1 ? 1 : g > 0x7fffffffLL ? 0x7fffffffLL : g);
}

// The counter is zeroed by a memset on the stream, not a kernel. The
// hydrogen grid: the blocks the card holds at once, fewer where the cells
// do not fill them.
template <typename T>
int launch_hydrogen(HArgs<T> a, cudaStream_t st) {
  const size_t smem = kThreads * sizeof(unsigned);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hydrogen_pass_kernel<T>, kThreads, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.count, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long full =
      static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
  const unsigned need = grid_for(a.n, kCells);
  const unsigned g = need < full ? need : static_cast<unsigned>(full);
  hydrogen_pass_kernel<T><<<g, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_helium(HeArgs<T> a, bool recomb, cudaStream_t st) {
  const cudaError_t err =
      cudaMemsetAsync(a.count, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kThreads * sizeof(unsigned);
  const unsigned g = grid_for(a.n);
  const bool heat = a.heat != nullptr;
  if (heat && recomb)
    helium_pass_kernel<T, true, true><<<g, kThreads, smem, st>>>(a);
  else if (heat)
    helium_pass_kernel<T, true, false><<<g, kThreads, smem, st>>>(a);
  else if (recomb)
    helium_pass_kernel<T, false, true><<<g, kThreads, smem, st>>>(a);
  else
    helium_pass_kernel<T, false, false><<<g, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chem

using namespace chem;

extern "C" {

// The hydrogen pass over n cells on `stream`: dt from `dt_ptr` (a 0-dim
// tensor on the device, dt_kind 1 float32, 2 float64) or `dt_value`
// (dt_kind 0); `mask` and `iters` may be null; `count` (int64) receives the
// not-converged cells; `params` the kHParams doubles. Returns the first
// cudaError_t of the memset and the launch that is not cudaSuccess.
#define HYDROGEN_ENTRY(NAME, TYPE)                                             \
  int NAME(const void* dt_ptr, int dt_kind, double dt_value,                  \
           const void* ndens, const void* temp, const void* xh,               \
           const void* xh_av, const void* phi, const void* mask,              \
           void* xh_out, void* xh_av_out, void* count, void* iters,           \
           long long n, int cap, const double* params, void* stream) {       \
    HArgs<TYPE> a{static_cast<const TYPE*>(ndens),                             \
                  static_cast<const TYPE*>(temp),                              \
                  static_cast<const TYPE*>(xh),                                \
                  static_cast<const TYPE*>(xh_av),                             \
                  static_cast<const TYPE*>(phi),                               \
                  static_cast<const bool*>(mask),                              \
                  static_cast<TYPE*>(xh_out),                                  \
                  static_cast<TYPE*>(xh_av_out),                               \
                  static_cast<unsigned long long*>(count),                     \
                  static_cast<int*>(iters),                                    \
                  n,                                                           \
                  cap,                                                         \
                  Dt{dt_ptr, dt_kind, dt_value},                               \
                  h_const<TYPE>(params)};                                      \
    return launch_hydrogen<TYPE>(a, static_cast<cudaStream_t>(stream));       \
  }

HYDROGEN_ENTRY(chemistry_pass_f32, float)
HYDROGEN_ENTRY(chemistry_pass_f64, double)

// The helium pass: as the hydrogen pass with the three species' fields,
// the three rates, `heat` (null: no secondary ionisations), `recomb` (the
// recombination photons) and the doubles of he_const.
#define HELIUM_ENTRY(NAME, TYPE)                                               \
  int NAME(const void* dt_ptr, int dt_kind, double dt_value,                  \
           const void* ndens, const void* temp, const void* xh,               \
           const void* xh_av, const void* y1, const void* y1_av,              \
           const void* y2, const void* y2_av, const void* phi_h,              \
           const void* phi_he1, const void* phi_he2, const void* heat,        \
           const void* mask, void* xh_out, void* xh_av_out, void* y1_out,     \
           void* y1_av_out, void* y2_out, void* y2_av_out, void* count,       \
           void* iters, long long n, int cap, int recomb,                     \
           const double* params, void* stream) {                              \
    using P = const TYPE*;                                                     \
    HeArgs<TYPE> a{static_cast<P>(ndens),     static_cast<P>(temp),            \
                   static_cast<P>(xh),        static_cast<P>(xh_av),           \
                   static_cast<P>(y1),        static_cast<P>(y1_av),           \
                   static_cast<P>(y2),        static_cast<P>(y2_av),           \
                   static_cast<P>(phi_h),     static_cast<P>(phi_he1),         \
                   static_cast<P>(phi_he2),   static_cast<P>(heat),            \
                   static_cast<const bool*>(mask),                             \
                   static_cast<TYPE*>(xh_out), static_cast<TYPE*>(xh_av_out),  \
                   static_cast<TYPE*>(y1_out), static_cast<TYPE*>(y1_av_out),  \
                   static_cast<TYPE*>(y2_out), static_cast<TYPE*>(y2_av_out),  \
                   static_cast<unsigned long long*>(count),                    \
                   static_cast<int*>(iters),  n,                               \
                   cap,                       Dt{dt_ptr, dt_kind, dt_value},   \
                   he_const<TYPE>(params)};                                    \
    return launch_helium<TYPE>(a, recomb != 0,                                 \
                               static_cast<cudaStream_t>(stream));            \
  }

HELIUM_ENTRY(chemistry_pass_he_f32, float)
HELIUM_ENTRY(chemistry_pass_he_f64, double)

const char* chemistry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
