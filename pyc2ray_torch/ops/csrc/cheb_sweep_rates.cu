// Fused Chebyshev-face sweep + box assembly + spectral-bin rates for NVIDIA
// Hopper (sm_90a).
//
// Replaces pyc2ray_tpu/ops/pallas_sweep.py::cheb_sweep_rates_pallas (body
// _kernel_fold_rates): K3 with the photoionization output alone, K3h with
// the photoheating output beside it (the TPU kernel's heat_bins). Plain
// version: pyc2ray_torch/ops/sweep.py::cheb_sweep_rates_ref.
//
// Phase A is K1's sweep (cheb_sweep.cuh): the cdin and the dcol of every
// valid face cell are stored at the cell's cartesian position in two
// scratch boxes (face memberships are disjoint, so these are stores, not
// the TPU kernel's read-modify-write adds). Phase B evaluates, per box cell,
//   phi  = flux S* dr / (dr^3 4 pi d2) sum_e w_e core_e / max(dcol, tiny)
//   heat = the same with the heating weights w_heat_e         (K3h only)
//   core_e = e^{-tau_in s_e} (-expm1(-dtau s_e)),
// masked by the rates table's valid channel (octahedron, clip, R^2 cut,
// source cell excluded) and cdin <= 2e30. The source cell is 0; the caller
// sets its closed form. The TPU kernel divides by dcol without a floor
// (0/0 at a zero-density cell); here dcol is floored at the type's
// smallest normal, as the unfused rate pass floors nHI.
//
// Design. Phase B of a source depends only on its own box, and one block
// per source would leave 124 of the 132 SMs idle during the arithmetic of
// E bins x 2 transcendentals per cell. So phase B is a second __global__
// on the same stream over a grid of B x Dc box planes; the stream order
// makes phase A's stores visible to it. Phase B reads a scratch cell only
// where the valid channel is set: every such cell is a valid face cell of
// exactly one shell, so the scratch boxes need no zeroing. The bins sit in
// shared memory, loaded once per block; exp/expm1 are the accurate expf /
// expm1f, not the fast __expf. The heating output is a template flag of
// phase B, chosen by a non-null heat pointer: each bin's exp and expm1 are
// evaluated once and feed both accumulators (bin_sums), so phi is the same
// bits with and without the heat output.
//
// Bound. The function reads the nHI box, the geometry tables and the rates
// table once and writes the phi box once (B = 8, Dc = 64, R1 = 31, f32:
// 8 + 10 + 2 + 8 MB, about 8.5 us at 3.35 TB/s; K3h writes 8 MB more); its
// arithmetic is the sweep's ~27 flops per face cell plus ~7 operations per
// bin and valid cell (K3h: 2 more per bin, and 2 more per cell). Phase A
// is K1's loop (a cluster per source, see cheb_sweep.cuh) and carries its
// chain of 3 (R1 - 1) dependent sub-steps; phase B is a dense pass over
// the card.

#include "cheb_sweep.cuh"

namespace {

using namespace cheb;

// Phase A: keep cdin and dcol of a valid face cell.
template <typename T>
struct StoreFold {
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
  sweep.run(1, tb.R1, StoreFold<T>{ci_all + src * D3, dc_all + src * D3});
}

// Phase B: block (b, i) evaluates plane i of source b's box. With HEAT the
// bins hold w_heat too and heat_all receives the photoheating rate.
template <typename T, bool HEAT>
__global__ void box_rates_kernel(const T* __restrict__ ci_all,
                                 const T* __restrict__ dc_all,
                                 const T* __restrict__ rt,
                                 const T* __restrict__ flux,
                                 const T* __restrict__ bins_s,
                                 const T* __restrict__ bins_w,
                                 const T* __restrict__ bins_wh, int E, int Dc,
                                 T sig, T s_fac, T* phi_all, T* heat_all) {
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
    phi_all[plane + jk] = phi;
    if (HEAT) heat_all[plane + jk] = heat;
  }
}

template <typename T>
int launch(const void* nhi, const void* sw, const void* path, const void* diag,
           const void* mask_m, const void* mask_p, const void* rt,
           const void* bins_s, const void* bins_w, const void* bins_wh,
           const void* flux, void* phi, void* heat, void* ci, void* dc,
           void* scratch, int E, double s_fac, int threads_b, int Dc, int c,
           int R1, double dr, double sig, const LaunchSpec& spec) {
  const cudaStream_t st = static_cast<cudaStream_t>(spec.stream);
  const int B = spec.B;
  const Tables<T> tb = make_tables<T>(sw, path, diag, mask_m, mask_p, Dc, c,
                                      R1, dr, sig);
  Plan pl;
  cudaError_t err = make_plan<T>(spec, Dc, 0, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_cluster(
      pl.rows ? sweep_fold_kernel<T, true> : sweep_fold_kernel<T, false>, spec,
      tb, pl, static_cast<const T*>(nhi), static_cast<T*>(ci),
      static_cast<T*>(dc), static_cast<T*>(scratch));
  if (rc != 0 || spec.max_clusters != nullptr) return rc;
  const bool with_heat = heat != nullptr;
  const auto phase_b = with_heat ? box_rates_kernel<T, true>
                                 : box_rates_kernel<T, false>;
  phase_b<<<B * Dc, threads_b, (with_heat ? 3 : 2) * E * sizeof(T), st>>>(
      static_cast<const T*>(ci), static_cast<const T*>(dc),
      static_cast<const T*>(rt), static_cast<const T*>(flux),
      static_cast<const T*>(bins_s), static_cast<const T*>(bins_w),
      static_cast<const T*>(bins_wh), E, Dc, static_cast<T>(sig),
      static_cast<T>(s_fac), static_cast<T*>(phi), static_cast<T*>(heat));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches phase A (as clusters, planned by the caller like the sweeps of
// cheb_sweep.cu) then phase B on `stream`; returns the first cudaError_t
// that is not cudaSuccess, else cudaSuccess. With `max_clusters` set it
// launches nothing and writes there how many of phase A's clusters are
// resident at once. `heat` and `bins_wh` are null for K3 and both set for
// K3h.
#define CHEB_SWEEP_RATES_ENTRY(NAME, TYPE)                                     \
  int NAME(const void* nhi, const void* sw, const void* path,                 \
           const void* diag, const void* mask_m, const void* mask_p,          \
           const void* rt, const void* bins_s, const void* bins_w,            \
           const void* bins_wh, const void* flux, void* phi, void* heat,      \
           void* ci, void* dc, void* scratch, int E, double s_fac,            \
           int threads_b, int B, int Dc, int c, int R1, double dr,            \
           double sig, int threads, int cluster, int shared_planes,           \
           int smem, int* max_clusters, void* stream) {                       \
    return launch<TYPE>(nhi, sw, path, diag, mask_m, mask_p, rt, bins_s,      \
                        bins_w, bins_wh, flux, phi, heat, ci, dc, scratch, E, \
                        s_fac, threads_b, Dc, c, R1, dr, sig,                 \
                        LaunchSpec{B, threads, cluster, shared_planes, smem,  \
                                   max_clusters, stream});                    \
  }

CHEB_SWEEP_RATES_ENTRY(cheb_sweep_rates_f32, float)
CHEB_SWEEP_RATES_ENTRY(cheb_sweep_rates_f64, double)

const char* cheb_sweep_rates_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
