// The box engine's kernels on NVIDIA Hopper (sm_90a), device code: the
// gather of nHI at the octahedron's sheet cells, the shell sweep and the
// rate pass of ops/raytrace_box.py's BoxRaytracer. trace_loop.cu launches
// them and issues a whole trace (box_trace_sweep) from the host side of its
// library, with its ordered accumulate (accumulate_boxes_kernel over the
// rated cells, struct Visit).
//
// Counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
// raytrace_box.py::BoxRaytracer._trace_jit: _extract_boxes and _shear
// (:153, :162), the lax.fori_loop over shells of _sweep (:196-277), _rates
// (:280) with _unshear (:178), and the lax.scan over batches (:392)), which
// XLA runs on the device as one program. No TPU kernel of its own: the JAX
// engine's trace is XLA code. Plain versions: ops/raytrace_box.py::
// BoxRaytracer._sheets, _sweep, _rates and _unshear.
//
//   sheet_gather_kernel  per valid sheet cell and source, nHI at the cell's
//                        place in the padded frame.
//   sheet_sweep_kernel   per source (a block), the incoming and outgoing
//                        column density of every valid sheet cell, shell
//                        after shell, one barrier a shell.
//   sheet_rates_kernel   per rated cell and source, the photoionization
//                        (and heating) rate per HI atom of the spectral
//                        bins, written into the source's rate box at the
//                        cell's box cell.
//
// Valid cells only. The plain engine computes every cell of the 2 Q Dc^2
// sheet stack, 6.7 times the octahedron's cells at the bench shape. The
// kernels work on the valid sheet cells, numbered shell after shell (in a
// shell the top sheet, then the bottom, each in (i, j) order: the engine's
// kernel_tables), and keep a source's values in that order. A cell's four
// corners are valid cells of earlier shells (their numbers in `corner`) or
// cells outside the octahedron (-1), where the plain stack holds 0: such a
// corner is 0 here too, read without a load, and its weight enters the sums
// as the plain version's does. Every valid cell is written before a later
// shell reads it, so the scratch is never read where it was not written.
//
// Shell 0. Its valid cells are the source's cell in both sheets, whose
// outgoing column density is nHI dr / 2 and whose incoming one 0, as the
// plain sweep sets them; the corners of shells 1 and 2 that fall on sheet 0
// elsewhere are outside the octahedron and read 0.
//
// The sweep. A block a source, its threads over a shell's cells, a barrier
// between shells. A cell's corners lie in shells max(q - 3, 0), max(q - 2,
// 0) (two) and max(q - 1, 0), so the outgoing column densities of the last
// four shells are all a shell reads: they sit in a ring of kRingSlots
// shells in shared memory where it fits a block (RING, the ring
// placement), else in global memory, read past L1 by __ldcg (the global
// placement, as the flat engine's); ops/box_sweep.py::box_plan picks the
// placement that keeps the most sources in flight. Either way every
// outgoing value is also stored to the (n, n_v) output. cdin = diag (c1 w1
// + c2 w2 + c3 w3 + c4 w4) / (w1 + w2 + w3 + w4), w = sw / max(c sig, 0.6),
// the sums in that order (the plain version's explicit adds, the JAX
// engine's order), cdout = cdin + nHI (path dr).
//
// The rate pass. A thread a rated cell (dist2 <= R^2, the equator in the
// top sheet only) and source, the rated cells in ascending box-cell order,
// so a warp's stores into the rate box are close together. Gamma = prefact
// sum_e w_e e^(-tau_in s_e) (-expm1(-dtau s_e)) / max(nHI, tiny), 0 where
// cdin exceeds MAX_COLDENSH; heat the same with the weights bins_wh. Each
// rated sheet cell is one box cell (the unshear is a map from box cells to
// sheet cells that is one to one on the rated ones), so the kernel writes
// the box directly; the caller zeroes the boxes, which then hold the plain
// version's +0 at every other cell, and the accumulate visits the rated
// cells alone.
//
// Rounding. Every operation is the one the plain version issues on the
// card, in its order and its type (rounded.cuh: explicitly rounded
// intrinsics, no FMA contraction; exp and expm1 the CUDA math functions
// that ATen calls; clamp with ATen's NaN rule). A Python scalar is rounded
// to the type (sig, 0.6, MAX_COLDENSH, dr / 2 formed in double); products
// keep the plain version's association ((flux sdr3) geominv, (nHI pdr) sig,
// pdr = path dr); S*/dr^3 is read on the device, where the plain version
// reads it. The result is the plain version's bit for bit.
//
// Bound. The gather reads the cells of the batch's octahedra in the frame
// and writes n_v values a source; the sweep's chain is Q - 1 barriers a
// source, a cell reads its 4 corners, 4 weights, path, diag and nHI and
// writes two values (about 25 operations, 5 divisions); the rate pass reads
// a rated cell's nHI and cdin and writes one or two values, and does an
// exp, an expm1 and about 8 operations a bin. chip_smoke.py's box_work
// counts them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace box {

#include "rounded.cuh"

constexpr int kThreads = 256;         // threads a block of the gather and
                                      // the rate pass
constexpr int kMaxSweepThreads = 1024;
constexpr int kRingSlots = 4;         // shells in the sweep's ring
constexpr double kMaxColdensH = 2.0e30;   // constants.MAX_COLDENSH

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() {
  return 1.17549435e-38f;                   // torch.finfo(float32).tiny
}
template <> __device__ __forceinline__ double tiny<double>() {
  return 2.2250738585072014e-308;
}

// The engine's tables on the device (ops/raytrace_box.py::kernel_tables)
// over its n_v valid sheet cells and n_r rated cells, and its scalars.
template <typename T>
struct Geom {
  const int* shell;     // (Q + 1,) the first valid cell of shell q
  const int* voff;      // (n_v,) offset in the padded frame from the box
                        // corner
  const int* corner;    // (4, n_v) the valid cell of each corner, -1 for
                        // one outside the octahedron
  const int* rv;        // (n_r,) the valid cell of each rated cell
  const int* rcell;     // (n_r,) its box cell, ascending
  const T* sw;          // (4, n_v) corner weights
  const T* path;        // (n_v,) path in cell units
  const T* diag;        // (n_v,) diagonal factor
  const T* geominv;     // (n_r,) 1 / (4 pi dist2 path), 1 at the source
  const T* visit;       // (Dc^3,) 1 at the rated box cells (the
                        // accumulate's visit), 0 elsewhere
  const T* bins_s;      // (E,) spectral bins: s, the photoionization and
  const T* bins_w;      // heating weights
  const T* bins_wh;
  int n_v, Q, Dc, n_r, E, P;   // P: the padded frame's side
  int max_shell;               // the valid cells of the largest shell
  T dr, sig, half_dr;
};

constexpr int kTabs = 13;   // pointers of make_geom's tabs
constexpr int kDims = 7;    // ints of its dims

// tabs: shell, voff, corner, rv, rcell, sw, path, diag, geominv, visit,
// bins_s, bins_w, bins_wh; dims: n_v, Q, Dc, n_r, E, P, max_shell; vals:
// dr, sig.
template <typename T>
Geom<T> make_geom(void* const* tabs, const int* dims, const double* vals) {
  Geom<T> g;
  g.shell = static_cast<const int*>(tabs[0]);
  g.voff = static_cast<const int*>(tabs[1]);
  g.corner = static_cast<const int*>(tabs[2]);
  g.rv = static_cast<const int*>(tabs[3]);
  g.rcell = static_cast<const int*>(tabs[4]);
  g.sw = static_cast<const T*>(tabs[5]);
  g.path = static_cast<const T*>(tabs[6]);
  g.diag = static_cast<const T*>(tabs[7]);
  g.geominv = static_cast<const T*>(tabs[8]);
  g.visit = static_cast<const T*>(tabs[9]);
  g.bins_s = static_cast<const T*>(tabs[10]);
  g.bins_w = static_cast<const T*>(tabs[11]);
  g.bins_wh = static_cast<const T*>(tabs[12]);
  g.n_v = dims[0];
  g.Q = dims[1];
  g.Dc = dims[2];
  g.n_r = dims[3];
  g.E = dims[4];
  g.P = dims[5];
  g.max_shell = dims[6];
  g.dr = static_cast<T>(vals[0]);
  g.sig = static_cast<T>(vals[1]);
  g.half_dr = static_cast<T>(0.5 * vals[0]);
  return g;
}

// Whether a launch of n sources fits the tables (the heat weights present
// where `heat`).
template <typename T>
bool fits(const Geom<T>& g, int n, bool heat) {
  const long long P = g.P;
  return g.n_v >= 1 && g.Q >= 1 && g.Dc >= 1 && g.n_r >= 1 && g.E >= 1 &&
         g.max_shell >= 1 &&
         P >= g.Dc && static_cast<long long>(g.Dc) * P * P < (1LL << 31) &&
         n >= 1 && n <= 65535 && (!heat || g.bins_wh != nullptr);
}

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y: valid cell v of
// source b = blockIdx.y, whose box starts at pos[b] in the padded frame
// (P^3); out (n, n_v).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sheet_gather_kernel(Geom<T> g, const T* frame, const int* pos, T* out) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (v >= g.n_v) return;
  const int* p = pos + 3 * b;
  const long long base =
      (static_cast<long long>(p[0]) * g.P + p[1]) * g.P + p[2];
  out[size_t(b) * g.n_v + v] = frame[base + g.voff[v]];
}

// The bytes of the sweep's ring: kRingSlots shells of max_shell values.
template <typename T>
__host__ __device__ inline size_t ring_bytes(const Geom<T>& g) {
  return size_t(kRingSlots) * g.max_shell * sizeof(T);
}

template <typename T>
__device__ __forceinline__ T* ring_mem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// Block s sweeps source s: from its valid cells' nHI (row s of nhi, (n,
// n_v)) the outgoing column densities into row s of cd and the incoming
// ones into row s of cdin. RING: the last kRingSlots shells' outgoing
// column densities in shared memory (ring_bytes of it), shell q in slot q
// mod kRingSlots. Every thread of the block passes the same barriers.
template <typename T, bool RING>
__global__ void __launch_bounds__(kMaxSweepThreads)
sheet_sweep_kernel(Geom<T> g, const T* nhi, T* cd, T* cdin) {
  const size_t at = size_t(blockIdx.x) * g.n_v;
  const T* no = nhi + at;
  T* co = cd + at;
  T* ci = cdin + at;
  T* ring = RING ? ring_mem<T>() : nullptr;
  const int nt = blockDim.x, t = threadIdx.x;
  // shell 0: the source's cell in both sheets, nHI dr / 2 out, 0 in
  for (int v = g.shell[0] + t; v < g.shell[1]; v += nt) {
    const T out = mul(no[v], g.half_dr);
    co[v] = out;
    if (RING) ring[v - g.shell[0]] = out;
    ci[v] = T(0);
  }
  const T lim = static_cast<T>(0.6);
  for (int q = 1; q < g.Q; ++q) {
    __syncthreads();             // shells q - 3 .. q - 1 are written
    const int start = g.shell[q], end = g.shell[q + 1];
    // RING: where the shell of corner k (lag 3, 2, 2, 1) starts in the
    // ring, less its first cell's number; this shell's slot likewise
    int from[4] = {0, 0, 0, 0}, into = 0;
    if (RING) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int lag = k == 0 ? 3 : (k == 3 ? 1 : 2);
        const int q2 = q > lag ? q - lag : 0;
        from[k] = (q2 % kRingSlots) * g.max_shell - g.shell[q2];
      }
      into = (q % kRingSlots) * g.max_shell - start;
    }
    for (int v = start + t; v < end; v += nt) {
      T cw[4], w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = g.corner[size_t(k) * g.n_v + v];
        const T c = n < 0 ? T(0) : (RING ? ring[from[k] + n] : __ldcg(co + n));
        w[k] = div(g.sw[size_t(k) * g.n_v + v], clamp_min(mul(c, g.sig), lim));
        cw[k] = mul(c, w[k]);
      }
      const T num = add(add(add(cw[0], cw[1]), cw[2]), cw[3]);
      const T den = add(add(add(w[0], w[1]), w[2]), w[3]);
      const T in = div(mul(g.diag[v], num), den);
      const T out = add(in, mul(no[v], mul(g.path[v], g.dr)));
      ci[v] = in;
      if (RING) {
        ring[into + v] = out;
        co[v] = out;
      } else {
        __stcg(co + v, out);
      }
    }
  }
}

// The pointers of one launch of the rate pass over n sources.
template <typename T>
struct RateIO {
  const T* nhi;           // (n, n_v) nHI at the valid cells
  const T* cdin;          // (n, n_v) incoming column densities
  const T* flux;          // (n,)
  const T* sdr3;          // S* / dr^3, on the device
  T* phi;                 // (n, Dc^3) rate boxes, the rated cells written
  T* heat;                // (n, Dc^3), null without the heat channel
};

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y: rated cell r of
// source b = blockIdx.y.
template <typename T, bool HEAT>
__global__ void __launch_bounds__(kThreads)
sheet_rates_kernel(Geom<T> g, RateIO<T> a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (r >= g.n_r) return;
  const int v = g.rv[r];
  const size_t k = size_t(b) * g.n_v + v;
  const T nhi = a.nhi[k], cin = a.cdin[k];
  const T tau_in = mul(cin, g.sig);
  const T dtau = mul(mul(nhi, mul(g.path[v], g.dr)), g.sig);
  const T prefact = mul(mul(a.flux[b], *a.sdr3), g.geominv[r]);
  T acc = T(0), acc_h = T(0);
  for (int e = 0; e < g.E; ++e) {
    const T se = g.bins_s[e];
    const T core = mul(exp_(mul(-tau_in, se)), -expm1_(mul(-dtau, se)));
    acc = add(acc, mul(g.bins_w[e], core));
    if (HEAT) acc_h = add(acc_h, mul(g.bins_wh[e], core));
  }
  // the max-column-density cutoff; a zero-density cell's rate per atom is
  // 0 (the smallest normal number as its density)
  const bool mask = cin <= static_cast<T>(kMaxColdensH);
  const T nhi_safe = clamp_min(nhi, tiny<T>());
  const size_t o = size_t(b) * g.Dc * g.Dc * g.Dc + g.rcell[r];
  a.phi[o] = mask ? div(mul(prefact, acc), nhi_safe) : T(0);
  if (HEAT) a.heat[o] = mask ? div(mul(prefact, acc_h), nhi_safe) : T(0);
}

}  // namespace box
