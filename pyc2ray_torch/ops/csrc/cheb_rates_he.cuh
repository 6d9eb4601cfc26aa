// The three-species (HI, HeI, HeII) spectral-bin rate pass of the helium
// engine for NVIDIA Hopper (sm_90a): per rated cell of the central rates
// subbox of B boxes, the photoionization rate of each species (and, with
// HEAT, the photoheating rate per HI atom) from the three species'
// coldensh_out boxes of K1 or K2 and their absorber boxes. Shared by
// cheb_rates.cu (one call per batch) and trace_loop.cu (the helium batch
// loop of a whole trace).
//
// Counterpart of pyc2ray_tpu/ops/raytrace_he.py::HeRaytracer._rates_he (no
// TPU kernel: XLA code there, two (cells, 3) x (3, E) einsums, an
// exp/expm1 block over (cells, E) and two (cells, E) x (E, 3) einsums).
// Plain version: pyc2ray_torch/ops/cheb_rates.py::rates_he_ref, op by op.
// Per cell of the (Ds)^3 subbox at box offset rb0 (channels of the table
// rt: path3, geominv, valid), species s = HI, HeI, HeII and bin e (se, w_se
// and wh_se are the engine's (3, E) tables: sigma_s(nu_e), w_e sigma_s(nu_e)
// and w_heat[s, e] sigma_s(nu_e)):
//   dcol_s = n_s (path3 dr),  cdin_s = cd_s - dcol_s
//   tau_e  = sum_s cdin_s se[s, e],  dtau_e = sum_s dcol_s se[s, e]
//   inv_e  = e^{-tau_e} (-expm1(-dtau_e)) / max(dtau_e, tiny)
//   G_s    = (flux S*/dr^3) geominv dcol_s sum_e inv_e w_se[s, e]
//            / max(n_s, tiny)
//   heat   = (flux S*/dr^3) geominv sum_s dcol_s sum_e inv_e wh_se[s, e]
//            / max(n_HI, tiny)                                  (HEAT only)
// G_s is 0 where the cell is not valid, where cdin_HI > 2e30 or where
// n_s <= 0; the heat where G_HI is. tiny is 1e-30 in float32 and 1e-280 in
// float64, the JAX engine's. cdin is rebuilt as cd - dcol as the JAX engine
// does, with its float32 cancellation at thick cells (ROADMAP §3): the
// plain version must stay the JAX package's twin.
//
// Design (the one of cheb_rates.cuh's rates_dense). One thread per rated
// cell of every box, B n_valid threads in 256-thread blocks over the
// engine's list of the subbox's rated cells (ops/cheb_rates.py::
// rated_cells); a cell that is not listed is never written, its outputs
// stay at the 0 the caller zeroed. The 6E (9E with HEAT) bin values sit in
// shared memory, loaded once per block (5.2 KB at 72 bins in float64). Per
// cell the three column densities and densities are loaded once, and the
// bins loop keeps its three (six with HEAT) sums in registers: one exp,
// one expm1 and one division per bin feed every sum. Every operation is an
// explicitly rounded intrinsic in the plain version's type and order (the
// species sums in the order HI, HeI, HeII, no FMA contraction), the scalars
// dr and S*/dr^3 rounded to the type once by the caller, so the pass is
// bit-equal to the plain one on the card. Index arithmetic is 32-bit (the
// caller keeps B (Ds)^3 below 2^31).
//
// Bound. It reads the list, path3 and geominv at the listed cells, the six
// boxes at the listed cells of every box, the fluxes and the bins once, and
// writes the 3-4 rates at the listed cells. At the bench shape (B = 8, Ds =
// Dc = 64, 72 bins, float32, 43% of the subbox rated) that is ~34 MB, 10
// us at 3.35 TB/s. Its arithmetic is ~20 operations per bin of a rated
// cell (26 with HEAT), two transcendentals and a division among them: at
// 67 TFLOP/s ~0.02 ms a batch, and a dense pass of the hydrogen bin sums
// runs at ~0.0019 ns per cell and bin (PERF.md), ~0.12 ms for this pass's
// cells and bins. The pass is bounded by its arithmetic, not by its bytes.

#pragma once

#include "cheb_sweep.cuh"

namespace cheb {

constexpr int kHeSpecies = 3;      // HI, HeI, HeII
constexpr int kHeThreads = 256;    // threads per block of the pass

// tiny of the helium rate pass (the JAX engine's): the floor of dtau and
// of the densities it divides by.
template <typename T> struct HeTiny;
template <> struct HeTiny<float> { static constexpr float v = 1e-30f; };
template <> struct HeTiny<double> { static constexpr double v = 1e-280; };

// One call of the pass: three species' boxes in, the 3-4 rate subboxes out,
// written at the n_valid listed cells only.
template <typename T>
struct HeRates {
  const T* cd[kHeSpecies];    // (B, Dc, Dc, Dc) coldensh_out boxes
  const T* n[kHeSpecies];     // (B, Dc, Dc, Dc) absorber boxes
  const T* rt;                // (3, Ds, Ds, Ds): path3, geominv, valid
  const int* cells;           // (n_valid,) the rated cells, ascending
  const T* flux;              // (B,)
  const T* se;                // (3, E) sigma_s(nu_e)
  const T* w_se;              // (3, E) w_e sigma_s(nu_e)
  const T* wh_se;             // (3, E) w_heat[s, e] sigma_s(nu_e); null
                              // without HEAT
  T* out[kHeSpecies + 1];     // (B, Ds, Ds, Ds) each: G_HI, G_HeI, G_HeII
                              // and (HEAT) the heat; 0 at every cell not
                              // listed
  int B, E, Dc, Ds, rb0, n_valid;
  T dr, sdr3;                 // sdr3 = S* / dr^3
};

// The bins of the pass into shared memory `sm`: se, then w_se, then (where
// `wh_se` is not null) wh_se; 6E or 9E values, species-major as the (3, E)
// tables. Ends with a __syncthreads().
template <typename T>
__device__ void load_he_bins(const T* se, const T* w_se, const T* wh_se,
                             int E, T* sm) {
  const int n = kHeSpecies * E;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sm[i] = se[i];
    sm[n + i] = w_se[i];
    if (wh_se != nullptr) sm[2 * n + i] = wh_se[i];
  }
  __syncthreads();
}

template <typename T, bool HEAT>
__global__ void rates_he_kernel(HeRates<T> k) {
  using A = Arith<T>;
  T* bins = shared_mem<T>();
  load_he_bins(k.se, k.w_se, HEAT ? k.wh_se : nullptr, k.E, bins);
  const int E = k.E, n3 = kHeSpecies * E;
  const T* se = bins;
  const T* w_se = bins + n3;
  const T* wh_se = bins + 2 * n3;
  const unsigned S = unsigned(k.Ds), S2 = S * S, S3 = S2 * S;
  const unsigned nv = unsigned(k.n_valid);
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= unsigned(k.B) * nv) return;
  const unsigned b = idx / nv, cell = unsigned(k.cells[idx - b * nv]);
  const unsigned i = cell / S2, jk = cell - i * S2, j = jk / S, l = jk - j * S;
  const size_t D = size_t(k.Dc), r = size_t(k.rb0);
  const size_t o = ((b * D + i + r) * D + j + r) * D + l + r;
  const T path = A::mul(k.rt[cell], k.dr);
  T n[kHeSpecies], dcol[kHeSpecies], cdin[kHeSpecies];
#pragma unroll
  for (int s = 0; s < kHeSpecies; ++s) {
    n[s] = k.n[s][o];
    dcol[s] = A::mul(n[s], path);
    cdin[s] = A::add(k.cd[s][o], -dcol[s]);
  }
  T out[kHeSpecies + 1] = {T(0), T(0), T(0), T(0)};
  if (cdin[0] <= T(kMaxColdensH)) {
    T acc[kHeSpecies] = {T(0), T(0), T(0)};
    T acc_h[kHeSpecies] = {T(0), T(0), T(0)};
    for (int e = 0; e < E; ++e) {
      T tau = A::mul(cdin[0], se[e]);
      T dtau = A::mul(dcol[0], se[e]);
#pragma unroll
      for (int s = 1; s < kHeSpecies; ++s) {
        tau = A::add(tau, A::mul(cdin[s], se[s * E + e]));
        dtau = A::add(dtau, A::mul(dcol[s], se[s * E + e]));
      }
      const T core = A::mul(A::exp(-tau), -A::expm1(-dtau));
      const T inv = A::div(core, max_lim(HeTiny<T>::v, dtau));
#pragma unroll
      for (int s = 0; s < kHeSpecies; ++s) {
        acc[s] = A::add(acc[s], A::mul(inv, w_se[s * E + e]));
        if (HEAT) acc_h[s] = A::add(acc_h[s], A::mul(inv, wh_se[s * E + e]));
      }
    }
    const T pref = A::mul(A::mul(k.flux[b], k.sdr3), k.rt[S3 + cell]);
#pragma unroll
    for (int s = 0; s < kHeSpecies; ++s)
      if (n[s] > T(0))
        out[s] = A::div(A::mul(pref, A::mul(dcol[s], acc[s])),
                        max_lim(HeTiny<T>::v, n[s]));
    if (HEAT && n[0] > T(0)) {
      T h = A::mul(dcol[0], acc_h[0]);
#pragma unroll
      for (int s = 1; s < kHeSpecies; ++s)
        h = A::add(h, A::mul(dcol[s], acc_h[s]));
      out[kHeSpecies] = A::div(A::mul(pref, h), max_lim(HeTiny<T>::v, n[0]));
    }
  }
  const size_t w = size_t(b) * S3 + cell;
#pragma unroll
  for (int s = 0; s < kHeSpecies; ++s) k.out[s][w] = out[s];
  if (HEAT) k.out[kHeSpecies][w] = out[kHeSpecies];
}

// The dynamic shared memory of the pass: 6E values, 9E with HEAT.
template <typename T>
size_t he_rates_smem(int E, bool heat) {
  return size_t(heat ? 3 : 2) * kHeSpecies * size_t(E < 0 ? 0 : E) *
         sizeof(T);
}

// Whether the sizes of `k` are ones the pass takes: a subbox inside the
// box, at most Ds^3 listed cells, B (Ds)^3 below 2^31, the heat channel's
// table and output both given or both not, and its bins within the 48 KB
// of shared memory a block has without asking.
template <typename T>
bool he_rates_fit(const HeRates<T>& k) {
  const bool heat = k.wh_se != nullptr;
  const size_t S3 = size_t(k.Ds) * k.Ds * k.Ds;
  return k.B >= 1 && k.Ds >= 1 && k.E >= 1 && k.rb0 >= 0 &&
         k.rb0 + k.Ds <= k.Dc && k.n_valid >= 0 && size_t(k.n_valid) <= S3 &&
         size_t(k.B) * S3 < (size_t(1) << 31) &&
         (k.n_valid == 0 || k.cells != nullptr) &&
         (k.out[kHeSpecies] != nullptr) == heat &&
         he_rates_smem<T>(k.E, heat) <= size_t(48) << 10;
}

// The launch of the helium pass on `st` (the HEAT form where k.wh_se is not
// null) of sizes he_rates_fit has taken; returns the cudaError_t of the
// launch. No rated cell: no launch.
template <typename T>
int issue_rates_he(const HeRates<T>& k, cudaStream_t st) {
  const size_t n = size_t(k.B) * k.n_valid;
  if (n == 0) return cudaSuccess;
  const bool heat = k.wh_se != nullptr;
  const unsigned blocks = unsigned((n + kHeThreads - 1) / kHeThreads);
  const size_t smem = he_rates_smem<T>(k.E, heat);
  if (heat)
    rates_he_kernel<T, true><<<blocks, kHeThreads, smem, st>>>(k);
  else
    rates_he_kernel<T, false><<<blocks, kHeThreads, smem, st>>>(k);
  return static_cast<int>(cudaGetLastError());
}

// The launch of the helium pass on `st` after he_rates_fit.
template <typename T>
int launch_rates_he(const HeRates<T>& k, cudaStream_t st) {
  if (!he_rates_fit(k)) return cudaErrorInvalidValue;
  return issue_rates_he(k, st);
}

}  // namespace cheb
