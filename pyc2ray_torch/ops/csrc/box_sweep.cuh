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
//   sheet_sweep_kernel   per source (a block), the incoming column
//                        density of every valid sheet cell, shell after
//                        shell, one barrier a shell.
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
// four shells are all a shell reads and all the sweep keeps: a ring of
// kRingSlots shells of max_shell cells a block, in shared memory where it
// fits (the placement for one source) or in global memory, read through L1
// (the placement for many: a block writes and reads its own ring, a
// barrier between). The function returns cdin alone, so no outgoing value
// leaves the ring. A thread loads a cell's tables and then its corners
// before the first of its five divisions. cdin = diag (c1 w1 + c2 w2 + c3
// w3 + c4 w4) / (w1 + w2 + w3 + w4), w = sw / max(c sig, 0.6), the sums in
// that order (the plain version's explicit adds, the JAX engine's order),
// cdout = cdin + nHI (path dr).
//
// The sweep's design (chip_smoke 3f's design steps, a launch of 1024 bench
// sources, "NVIDIA H100 80GB HBM3, 700.00 W"; the forms that lost live in
// csrc/box_probe.cu, which only chip_smoke builds): the first port stored every
// outgoing value to an (n, n_v) array that was also its ring, read past L1
// (3.61 ms). A ring of its own, read through L1, took it to 2.54 ms: the
// corners' reads are L1 hits, not L2 traffic (read past L1 the same kernel
// takes 3.52 ms). The tables are not what binds: read L1-hot they do not
// help (2.91 ms). Several sources a thread (S = 2, 4, 8: 2.73, 3.92, 6.77
// ms) or a block (a thread each: 3.14-3.54 ms) read a cell's tables once,
// but hold fewer blocks in flight and lose, as does a persistent grid of
// half the blocks (3.47 ms); the shared ring holds one block an SM and
// loses at the bench (3.21 ms), and wins for one source. Taking the
// divisions out saves ~0.35 ms (a probe); the kernel's own instructions
// (150 a cell and source) are 0.36 of its time at the issue rate.
//
// The rate pass. A thread a rated cell (dist2 <= R^2, the equator in the
// top sheet only) and source, the rated cells in ascending box-cell order,
// so a warp's stores into the rate box are close together; one launch
// covers a chunk of batches (box_trace's chunk: 8 at the bench, so its
// last wave is a small share of the launch). Gamma = prefact sum_e w_e
// e^(-tau_in s_e) (-expm1(-dtau s_e)) / max(nHI, tiny), 0 where cdin
// exceeds MAX_COLDENSH; heat the same with the weights bins_wh. The bins
// are kernel parameters (E <= kParamBins; else loaded from the tables),
// two a trip. Each rated sheet cell is one box cell (the unshear is a map
// from box cells to sheet cells that is one to one on the rated ones), so
// the kernel writes the box directly; the caller zeroes the boxes, which
// then hold the plain version's +0 at every other cell, and the accumulate
// visits the rated cells alone. A persistent grid of the blocks the card
// holds and one bin a trip lost to a thread a pair and two (design steps:
// 32.3 against 27.8 us a batch of 8 sources, the first port 28.5); a launch
// a chunk of 8 batches takes 24.0 us a batch; each exact bin's expf, expm1f
// and products are ~46 instructions.
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
// and writes n_v values a source; the sweep reads its tables once, nHI in
// and cdin out (a cell's 4 corners, 4 weights, path and diag; about 27
// operations, 5 divisions; its chain is Q - 1 barriers a source); the rate
// pass reads a rated cell's nHI and cdin and writes one or two values, and
// does an exp, an expm1 and about 8 operations a bin. chip_smoke.py's
// box_work counts them.
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

// The bytes of one block's ring: kRingSlots shells of max_shell cells.
template <typename T>
__host__ __device__ inline size_t ring_bytes(const Geom<T>& g) {
  return size_t(kRingSlots) * g.max_shell * sizeof(T);
}

template <typename T>
__device__ __forceinline__ T* ring_mem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// The pointers of one launch of the sweep over n sources.
template <typename T>
struct SweepIO {
  const T* nhi;   // (n, n_v) nHI at the valid cells
  T* cdin;        // (n, n_v) incoming column densities, written
  T* ring;        // the global placement's rings (gridDim.x ring_bytes):
                  // block k's at ring + k kRingSlots max_shell; null in the
                  // shared placement
  int n;
};

// One cell v of a shell of the sweep of the source whose row of io.nhi and
// io.cdin starts at `at`: the cell's tables (corner numbers, weights, path,
// diag) and then its corners loaded before the first division, then its
// weights, incoming and outgoing column densities. from, into: the ring's
// places of the corners' shells and of this one, less their first cells'
// numbers. (io stays in the kernel's parameters: a source costs the
// registers of `at` alone.)
template <typename T>
__device__ __forceinline__ void sweep_cell(const Geom<T>& g,
                                           const SweepIO<T>& io, T* ring,
                                           size_t at, const int (&from)[4],
                                           int into, int v) {
  const T lim = static_cast<T>(0.6);
  int n[4];
  T sw[4], c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n[k] = g.corner[size_t(k) * g.n_v + v];
    sw[k] = g.sw[size_t(k) * g.n_v + v];
  }
  const T diag = g.diag[v], pdr = mul(g.path[v], g.dr);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c[k] = n[k] < 0 ? T(0) : ring[from[k] + n[k]];
  T cw[4], w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = div(sw[k], clamp_min(mul(c[k], g.sig), lim));
    cw[k] = mul(c[k], w[k]);
  }
  const T num = add(add(add(cw[0], cw[1]), cw[2]), cw[3]);
  const T den = add(add(add(w[0], w[1]), w[2]), w[3]);
  const T in = div(mul(diag, num), den);
  const T out = add(in, mul(io.nhi[at + v], pdr));
  io.cdin[at + v] = in;
  ring[into + v] = out;
}

// Block k sweeps sources k, k + gridDim.x, ... (a block a source where the
// grid covers them, the engine's launch; fewer blocks where the global
// rings' scratch bounds them) from their valid cells' nHI (rows of io.nhi),
// writing the incoming column densities (rows of io.cdin), a thread a cell
// of the shell (sweep_cell). The last kRingSlots shells' outgoing column
// densities live in the block's ring, shell q in slot q mod kRingSlots: in
// shared memory (SHARED) or in global memory (io.ring, read through L1: the
// block writes its ring before a barrier and reads it after). Every thread
// of the block passes the same barriers.
template <typename T, bool SHARED>
__global__ void __launch_bounds__(kMaxSweepThreads)
sheet_sweep_kernel(Geom<T> g, SweepIO<T> io) {
  const int nt = blockDim.x, t = threadIdx.x;
  T* ring = SHARED ? ring_mem<T>()
                   : io.ring + size_t(blockIdx.x) * kRingSlots * g.max_shell;
  for (int b = blockIdx.x; b < io.n; b += gridDim.x) {
    const size_t at = size_t(b) * g.n_v;
    __syncthreads();          // the previous source's reads are done
    // shell 0: the source's cell in both sheets, nHI dr / 2 out, 0 in
    for (int v = g.shell[0] + t; v < g.shell[1]; v += nt) {
      ring[v - g.shell[0]] = mul(io.nhi[at + v], g.half_dr);
      io.cdin[at + v] = T(0);
    }
    for (int q = 1; q < g.Q; ++q) {
      __syncthreads();        // shells q - 3 .. q - 1 are written
      const int start = g.shell[q], end = g.shell[q + 1];
      // where the shell of corner k (lag 3, 2, 2, 1) starts in the ring,
      // less its first cell's number; this shell's slot likewise
      int from[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int lag = k == 0 ? 3 : (k == 3 ? 1 : 2);
        const int q2 = q > lag ? q - lag : 0;
        from[k] = (q2 % kRingSlots) * g.max_shell - g.shell[q2];
      }
      const int into = (q % kRingSlots) * g.max_shell - start;
      for (int v = start + t; v < end; v += nt)
        sweep_cell<T>(g, io, ring, at, from, into, v);
    }
  }
}

// The bins the rate pass takes as kernel parameters (E <= kParamBins):
// s, the photoionization and the heating weights, in the engine's type.
constexpr int kParamBins = 32;
template <typename T>
struct Bins {
  T s[kParamBins], w[kParamBins], wh[kParamBins];
};

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

// Thread i takes the pair (source b, rated cell r) of n sources, i = b n_r
// + r: the photoionization (and heating) rate per HI atom of the spectral
// bins at r, written into source b's rate box at the cell's box cell.
// PARAM: the bins from the kernel's parameters `bins` (E <= kParamBins; the
// loop's index is the same in every thread, so they are operands of the
// multiplies), else from the tables; two bins a trip. n n_r < 2^31
// (box::rates_fit).
template <typename T, bool HEAT, bool PARAM>
__global__ void __launch_bounds__(kThreads)
sheet_rates_kernel(Geom<T> g, RateIO<T> a, Bins<T> bins, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * g.n_r) return;
  const int b = i / g.n_r, r = i - b * g.n_r;
  const int v = g.rv[r];
  const size_t k = size_t(b) * g.n_v + v;
  const T nhi = a.nhi[k], cin = a.cdin[k];
  const T tau_in = mul(cin, g.sig);
  const T dtau = mul(mul(nhi, mul(g.path[v], g.dr)), g.sig);
  const T prefact = mul(mul(a.flux[b], *a.sdr3), g.geominv[r]);
  T acc = T(0), acc_h = T(0);
#pragma unroll 2
  for (int e = 0; e < g.E; ++e) {
    const T se = PARAM ? bins.s[e] : g.bins_s[e];
    const T core = mul(exp_(mul(-tau_in, se)), -expm1_(mul(-dtau, se)));
    acc = add(acc, mul(PARAM ? bins.w[e] : g.bins_w[e], core));
    if (HEAT) acc_h = add(acc_h, mul(PARAM ? bins.wh[e] : g.bins_wh[e],
                                     core));
  }
  // the max-column-density cutoff; a zero-density cell's rate per atom is
  // 0 (the smallest normal number as its density)
  const bool mask = cin <= static_cast<T>(kMaxColdensH);
  const T nhi_safe = clamp_min(nhi, tiny<T>());
  const size_t o = size_t(b) * g.Dc * g.Dc * g.Dc + g.rcell[r];
  a.phi[o] = mask ? div(mul(prefact, acc), nhi_safe) : T(0);
  if (HEAT) a.heat[o] = mask ? div(mul(prefact, acc_h), nhi_safe) : T(0);
}

// Whether a rate launch of n sources fits its 32-bit pair index.
template <typename T>
bool rates_fit(const Geom<T>& g, int n) {
  return static_cast<long long>(n) * g.n_r < (1LL << 31);
}

// The bins of the tables as the rate pass's parameters: `bins` (3 E
// doubles: s, w, wh, each exact in T), E <= kParamBins.
template <typename T>
Bins<T> make_bins(const double* bins, int E) {
  Bins<T> b{};
  for (int e = 0; e < E && e < kParamBins; ++e) {
    b.s[e] = static_cast<T>(bins[e]);
    b.w[e] = static_cast<T>(bins[E + e]);
    b.wh[e] = static_cast<T>(bins[2 * E + e]);
  }
  return b;
}

// The launches of the box kernels (host code).

constexpr size_t kMaxSmem = 232448;   // a block's dynamic shared memory

// The sweep, the ring in shared memory (SHARED) or global: `blocks` blocks
// of `threads` threads (fewer than io.n: each block sweeps source after
// source in its own ring), the ring's shared memory allowed for the kernel.
// Returns the launch's cudaError_t.
template <typename T, bool SHARED>
int launch_sweep(const Geom<T>& g, const SweepIO<T>& io, int threads,
                 int blocks, cudaStream_t st) {
  const auto kern = sheet_sweep_kernel<T, SHARED>;
  const size_t smem = SHARED ? ring_bytes(g) : 0;
  if (threads < 32 || threads > kMaxSweepThreads || threads % 32 != 0 ||
      blocks < 1 || smem > kMaxSmem || (!SHARED && io.ring == nullptr))
    return cudaErrorInvalidValue;
  if (SHARED) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<blocks, threads, smem, st>>>(g, io);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of `kern` with `threads` threads and `smem` bytes of
// shared memory the card holds at once.
inline int resident(const void* kern, int threads, size_t smem, int* held) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
  *held = per_sm * sms;
  return static_cast<int>(err);
}

template <typename T, bool SHARED>
int sweep_resident(const Geom<T>& g, int threads, int* held) {
  const size_t smem = SHARED ? ring_bytes(g) : 0;
  if (threads < 32 || threads > kMaxSweepThreads || threads % 32 != 0 ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  return resident(
      reinterpret_cast<const void*>(sheet_sweep_kernel<T, SHARED>), threads,
      smem, held);
}

template <typename T, bool HEAT, bool PARAM>
int launch_rates_form(const Geom<T>& g, const RateIO<T>& a,
                      const Bins<T>& bins, int n, cudaStream_t st) {
  const int blocks = static_cast<int>(
      (static_cast<long long>(n) * g.n_r + kThreads - 1) / kThreads);
  sheet_rates_kernel<T, HEAT, PARAM><<<blocks, kThreads, 0, st>>>(g, a, bins,
                                                                 n);
  return static_cast<int>(cudaGetLastError());
}

// The rate pass over n sources, a pair a thread: the bins as parameters
// where E <= kParamBins, else from the tables. Returns the launch's
// cudaError_t.
template <typename T>
int launch_rates(const Geom<T>& g, const RateIO<T>& a, const Bins<T>& bins,
                 int n, cudaStream_t st) {
  if (!rates_fit(g, n)) return cudaErrorInvalidValue;
  const bool param = g.E <= kParamBins;
  if (a.heat)
    return param ? launch_rates_form<T, true, true>(g, a, bins, n, st)
                 : launch_rates_form<T, true, false>(g, a, bins, n, st);
  return param ? launch_rates_form<T, false, true>(g, a, bins, n, st)
               : launch_rates_form<T, false, false>(g, a, bins, n, st);
}

}  // namespace box
