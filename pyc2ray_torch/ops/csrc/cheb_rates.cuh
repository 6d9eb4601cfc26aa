// The dense spectral-bin rate pass of the unfused sweep modes for NVIDIA
// Hopper (sm_90a): the photoionization rate (and, with HEAT, the
// photoheating rate) of every cell of the central rates subbox of B boxes,
// from the coldensh_out boxes of K1 or K2. Shared by cheb_rates.cu (one call
// per batch) and trace_loop.cu (the batch loop of a whole trace).
//
// Counterpart of the XLA fusion of pyc2ray_tpu/ops/raytrace_cheb.py::
// ChebRaytracer._rates (no TPU kernel: XLA fuses the pass into a few
// fusions there). Plain version: pyc2ray_torch/ops/cheb_rates.py::
// rates_dense_ref, op by op. Per cell of the (Ds)^3 subbox at box offset
// rb0 (channels of the rates-subbox table rt: path3, geominv, valid):
//   dcol = nHI (path3 dr),  cdin = cd - dcol
//   phi  = (flux S*/dr^3) geominv sum_e w_e core_e / max(nHI, tiny)
//   heat = the same with the heating weights w_heat_e           (HEAT only)
//   core_e = e^{-cdin sig s_e} (-expm1(-dcol sig s_e)),
// and 0 where the cell is not valid or cdin > 2e30. cdin is rebuilt as cd -
// dcol as the JAX engine does, with its float32 cancellation at thick cells
// (ROADMAP §3): the plain version must stay the JAX package's twin.
//
// Design. The pass evaluates only the cells of the subbox that the table
// rates (its valid channel, 38-47% of the subbox at the engines' shapes):
// the engine lists them once, as int32 row-major indices in ascending order
// (ops/cheb_rates.py::rated_cells), and the grid holds one thread per listed
// cell of every box, B n_valid threads in 256-thread blocks, thread t on
// box t / n_valid and listed cell t mod n_valid. Consecutive threads take
// consecutive rated cells, so the loads stay coalesced along rows, and no
// lane idles beside an unrated cell (one thread per subbox cell ran 1.59x
// the lanes the rated cells need at the bench shape, 1.21x at R = 100). A
// cell that is not listed is never written: its output is 0 from the
// caller (the trace loop zeroes its rate boxes once per trace, the
// standalone pass allocates them zeroed). The bins sit in shared memory,
// loaded once per block (load_bins); the per-cell core is bin_sums of
// cheb_sweep.cuh, the one K3's phase B runs, so a bin's exp and expm1 feed
// both sums. Every operation is an explicitly rounded intrinsic in the plain
// version's type and order (no FMA contraction), the scalars dr, sig and
// S*/dr^3 rounded to the type once by the caller, so the pass is bit-equal
// to the plain one on the card. Index arithmetic is 32-bit (the caller
// keeps B (Ds)^3 below 2^31).
//
// Bound. It reads the list, path3 and geominv at the listed cells, cd and
// nHI at the listed cells of every box, the fluxes and the bins once, and
// writes phi (and heat) at the listed cells. At the bench shape (B = 8, Ds =
// Dc = 64, float32), where 43% of the cells are rated, that is 0.45 MB of
// list, 0.9 MB of path3 and geominv, 7.2 MB of cd and nHI and 3.6 MB of phi:
// about 3.6 us at 3.35 TB/s. Its arithmetic is ~7 operations per bin of a
// rated cell, two of them transcendentals; the floor of that on this card
// is rated cells x bins x the measured time per cell and bin of a dense
// pass (PERF.md: ~0.0019 ns, ~0.024 ms at the bench shape). The pass is
// bounded by its transcendentals, not by its bytes.

#pragma once

#include "cheb_sweep.cuh"

namespace cheb {

constexpr int kDenseThreads = 256;   // threads per block of the rate pass

// One call of the pass: B boxes in, B (Ds)^3 rate subboxes out, written at
// the n_valid listed cells only.
template <typename T>
struct DenseRates {
  const T* cd;       // (B, Dc, Dc, Dc) coldensh_out boxes
  const T* nhi;      // (B, Dc, Dc, Dc) HI density boxes
  const T* rt;       // (3, Ds, Ds, Ds): path3, geominv, valid
  const int* cells;  // (n_valid,) the rated cells of the subbox, ascending
  const T* flux;     // (B,)
  const T* bins_s;
  const T* bins_w;
  const T* bins_wh;  // the heating weights, null without HEAT
  T* phi;            // (B, Ds, Ds, Ds), 0 at every cell not listed
  T* heat;           // (B, Ds, Ds, Ds), the same; null without HEAT
  int B, E, Dc, Ds, rb0, n_valid;
  T dr, sig, sdr3;   // sdr3 = S* / dr^3
};

template <typename T, bool HEAT>
__global__ void rates_dense_kernel(DenseRates<T> k) {
  using A = Arith<T>;
  T* bins = shared_mem<T>();
  load_bins(k.bins_s, k.bins_w, k.E, bins, HEAT ? k.bins_wh : nullptr);
  const unsigned S = unsigned(k.Ds), S2 = S * S, S3 = S2 * S;
  const unsigned nv = unsigned(k.n_valid);
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= unsigned(k.B) * nv) return;
  const unsigned b = idx / nv, cell = unsigned(k.cells[idx - b * nv]);
  const unsigned i = cell / S2, jk = cell - i * S2, j = jk / S, l = jk - j * S;
  const size_t D = size_t(k.Dc), r = size_t(k.rb0);
  const size_t o = ((b * D + i + r) * D + j + r) * D + l + r;
  T phi = T(0), heat = T(0);
  const T n = k.nhi[o];
  const T dcol = A::mul(n, A::mul(k.rt[cell], k.dr));
  const T cdin = A::add(k.cd[o], -dcol);
  if (cdin <= T(kMaxColdensH)) {
    T acc, acc_h;
    bin_sums<T, HEAT>(A::mul(cdin, k.sig), A::mul(dcol, k.sig), bins, k.E,
                      acc, acc_h);
    const T pref = A::mul(A::mul(k.flux[b], k.sdr3), k.rt[S3 + cell]);
    const T nsafe = max_lim(A::tiny, n);
    phi = A::div(A::mul(pref, acc), nsafe);
    if (HEAT) heat = A::div(A::mul(pref, acc_h), nsafe);
  }
  k.phi[b * S3 + cell] = phi;
  if (HEAT) k.heat[b * S3 + cell] = heat;
}

// The launch of the pass on `st` (the HEAT form where k.heat is not null);
// returns the first cudaError_t that is not cudaSuccess. No rated cell: no
// launch.
template <typename T>
int launch_rates_dense(const DenseRates<T>& k, cudaStream_t st) {
  const bool heat = k.heat != nullptr;
  const size_t S3 = size_t(k.Ds) * k.Ds * k.Ds, n = size_t(k.B) * k.n_valid;
  if (k.B < 1 || k.Ds < 1 || k.E < 0 || k.rb0 < 0 || k.rb0 + k.Ds > k.Dc ||
      k.n_valid < 0 || size_t(k.n_valid) > S3 ||
      size_t(k.B) * S3 >= (size_t(1) << 31) ||
      (k.bins_wh != nullptr) != heat)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = unsigned((n + kDenseThreads - 1) / kDenseThreads);
  const size_t smem = (heat ? 3 : 2) * size_t(k.E) * sizeof(T);
  if (heat)
    rates_dense_kernel<T, true><<<blocks, kDenseThreads, smem, st>>>(k);
  else
    rates_dense_kernel<T, false><<<blocks, kDenseThreads, smem, st>>>(k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cheb
