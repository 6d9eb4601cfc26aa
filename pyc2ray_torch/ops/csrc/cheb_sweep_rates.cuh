// Device code of the fused Chebyshev-face sweep + box assembly +
// spectral-bin rates (K3, K3h; the design is described in
// cheb_sweep_rates.cu) and the host function that launches its two phases.
// Shared by cheb_sweep_rates.cu (one call per batch) and trace_loop.cu (the
// batch loop of a whole trace).

#pragma once

#include "cheb_sweep.cuh"

namespace cheb {

// Phase A: keep cdin and dcol of a valid face cell, inside the sub-step.
template <typename T>
struct KeepFold {
  static constexpr bool kDeferred = false;
  T* ci;
  T* dc;
  __device__ void operator()(const FaceCell<T>& f) const {
    ci[f.o] = f.cdin;
    dc[f.o] = f.dcol;
  }
};

template <typename T, bool SH>
__global__ void sweep_fold_kernel(Tables<T> tb, Plan pl,
                                  const T* __restrict__ nhi_all, T* ci_all,
                                  T* dc_all, T* scratch_all) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc, D3 = D2 * tb.Dc;
  const size_t src = blockIdx.x >> pl.lgC;
  const T* nhi = nhi_all + src * D3;
  const Sweep<T, SH> sweep(tb, pl, nhi, SH ? nullptr : scratch_all + src * 12 * D2);
  sweep.init(nullptr, 0, source_cd(tb, nhi));
  sweep.run(1, tb.R1, KeepFold<T>{ci_all + src * D3, dc_all + src * D3});
}

// Phase B: block (b, i) evaluates plane i of source b's box. With HEAT the
// bins hold w_heat too and heat_all receives the photoheating rate. The
// source cell (plane c, position (c, c)) gets its closed form.
template <typename T, bool HEAT>
__global__ void box_rates_kernel(const T* __restrict__ nhi_all,
                                 const T* __restrict__ ci_all,
                                 const T* __restrict__ dc_all,
                                 const T* __restrict__ rt,
                                 const T* __restrict__ flux,
                                 const T* __restrict__ bins_s,
                                 const T* __restrict__ bins_w,
                                 const T* __restrict__ bins_wh, int E, int Dc,
                                 int c, T dr, T sig, T s_fac, T sdr3,
                                 T* phi_all, T* heat_all) {
  using A = Arith<T>;
  const int b = blockIdx.x / Dc, i = blockIdx.x % Dc;
  const size_t D2 = size_t(Dc) * Dc;
  const size_t plane = (size_t(b) * Dc + i) * D2;        // (b, i) in a box
  const T* d2_tab = rt + size_t(i) * 2 * D2;             // channel 0
  const T* valid = d2_tab + D2;                          // channel 1
  T* bins = shared_mem<T>();
  load_bins(bins_s, bins_w, E, bins, HEAT ? bins_wh : nullptr);
  const T fs = A::mul(flux[b], s_fac);
  for (size_t jk = threadIdx.x; jk < D2; jk += blockDim.x) {
    T phi = T(0), heat = T(0);
    if (valid[jk] > T(0.5)) {
      const T cdin = ci_all[plane + jk];
      const T dcol = dc_all[plane + jk];
      if (cdin <= T(kMaxColdensH)) {
        T acc, acc_h;
        bin_sums<T, HEAT>(A::mul(cdin, sig), A::mul(dcol, sig), bins, E, acc,
                          acc_h);
        const T pref = A::div(fs, A::mul(d2_tab[jk], T(kFourPi)));
        const T dsafe = max_lim(Arith<T>::tiny, dcol);
        phi = A::div(A::mul(pref, acc), dsafe);
        if (HEAT) heat = A::div(A::mul(pref, acc_h), dsafe);
      }
    }
    if (i == c && jk == size_t(c) * Dc + c) {              // the source cell
      const T n = nhi_all[plane + jk];
      const T cd = A::mul(n, A::mul(T(0.5), dr));          // as source_cd
      phi = source_rate(n, cd, flux[b], sdr3, sig, bins, bins + E, E);
      if (HEAT)
        heat = source_rate(n, cd, flux[b], sdr3, sig, bins, bins + 2 * E, E);
    }
    phi_all[plane + jk] = phi;
    if (HEAT) heat_all[plane + jk] = heat;
  }
}

// The launch of both phases for one batch.

// The pointers of one batch's K3 (K3h where `heat` is not null): the nHI
// boxes in, phase A's cdin and dcol boxes, the rate boxes out.
template <typename T>
struct RatesCall {
  const T* nhi;
  const T* rt;
  const T* bins_s;
  const T* bins_w;
  const T* bins_wh;
  const T* flux;      // (B,)
  T* phi;
  T* heat;
  T* ci;
  T* dc;
  T* scratch;         // the planes where they are not shared
  int E, threads_b;
  T s_fac, sdr3;
};

// Launch phase A (as clusters, by `pl`) then phase B on spec.stream; with
// spec.max_clusters only ask how many of phase A's clusters fit. Returns the
// first cudaError_t that is not cudaSuccess.
template <typename T>
int launch_rates(const Tables<T>& tb, const Plan& pl, const LaunchSpec& spec,
                 const RatesCall<T>& k) {
  const int rc = launch_cluster(
      pl.rows ? sweep_fold_kernel<T, true> : sweep_fold_kernel<T, false>, spec,
      tb, pl, k.nhi, k.ci, k.dc, k.scratch);
  if (rc != 0 || spec.max_clusters != nullptr) return rc;
  const bool with_heat = k.heat != nullptr;
  const auto phase_b = with_heat ? box_rates_kernel<T, true>
                                 : box_rates_kernel<T, false>;
  phase_b<<<spec.B * tb.Dc, k.threads_b, (with_heat ? 3 : 2) * k.E * sizeof(T),
            static_cast<cudaStream_t>(spec.stream)>>>(
      k.nhi, k.ci, k.dc, k.rt, k.flux, k.bins_s, k.bins_w, k.bins_wh, k.E,
      tb.Dc, tb.c, tb.dr, tb.sig, k.s_fac, k.sdr3, k.phi, k.heat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cheb
