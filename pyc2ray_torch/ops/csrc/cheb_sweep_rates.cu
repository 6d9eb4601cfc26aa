// Fused Chebyshev-face sweep + box assembly + spectral-bin rates for NVIDIA
// Hopper (sm_90a).
//
// Replaces pyc2ray_tpu/ops/pallas_sweep.py::cheb_sweep_rates_pallas (body
// _kernel_fold_rates): K3 with the photoionization output alone, K3h with
// the photoheating output beside it (the TPU kernel's heat_bins), and the
// source cell's closed form that the engine set afterwards. Plain version:
// pyc2ray_torch/ops/sweep.py::cheb_sweep_rates_ref.
//
// Phase A is K1's sweep (cheb_sweep.cuh): the cdin and the dcol of every
// valid face cell are stored at the cell's cartesian position in two
// scratch boxes (face memberships are disjoint, so these are stores, not
// the TPU kernel's read-modify-write adds). Phase B evaluates, per box cell,
//   phi  = flux S* dr / (dr^3 4 pi d2) sum_e w_e core_e / max(dcol, tiny)
//   heat = the same with the heating weights w_heat_e         (K3h only)
//   core_e = e^{-tau_in s_e} (-expm1(-dtau s_e)),
// masked by the rates table's valid channel (octahedron, clip, R^2 cut,
// source cell excluded) and cdin <= 2e30. The source cell gets its closed
// form (source_rate of cheb_sweep.cuh; with the heating weights for the heat
// box) from the thread of phase B that owns it, so the boxes are complete.
// The TPU kernel divides by dcol without a floor (0/0 at a zero-density
// cell); here dcol is floored at the type's smallest normal, as the unfused
// rate pass floors nHI.
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
// bits with and without the heat output. A one-kernel form (phase A's
// threads handing their cells through a ring in shared memory to rate
// threads of the same block, as K1f does) was built and measured behind
// this one on the H100 and taken out (PERF.md): the rate threads cost the
// block its second place on an SM, so the sweep runs in clusters of 8, not
// 16, and they share the chain's instruction slots, where phase B has the
// whole card to itself for a few microseconds.
//
// Bound. The function reads the nHI box, the geometry tables and the rates
// table once and writes the phi box once (B = 8, Dc = 64, R1 = 31, f32:
// 8 + 10 + 2 + 8 MB, about 8.5 us at 3.35 TB/s; K3h writes 8 MB more); its
// arithmetic is the sweep's ~27 flops per face cell plus ~7 operations per
// bin and valid cell (K3h: 2 more per bin, and 2 more per cell), whose
// floor on this card is rated cells x bins x the measured time per cell
// and bin of a dense pass (PERF.md). Phase A is K1's loop (a cluster per
// source, see cheb_sweep.cuh) and carries its chain of 3 (R1 - 1) dependent
// sub-steps; phase B is a dense pass over the card.

#include "cheb_sweep_rates.cuh"

namespace {

using namespace cheb;

template <typename T>
int launch(const void* nhi, const void* sw, const void* path, const void* diag,
           const void* mask_m, const void* mask_p, const void* rt,
           const void* bins_s, const void* bins_w, const void* bins_wh,
           const void* flux, void* phi, void* heat, void* ci, void* dc,
           void* scratch, int E, double s_fac, double sdr3, int threads_b,
           int Dc, int c, int R1, double dr, double sig,
           const LaunchSpec& spec) {
  const Tables<T> tb = make_tables<T>(sw, path, diag, mask_m, mask_p, Dc, c,
                                      R1, dr, sig);
  Plan pl;
  const cudaError_t err = make_plan<T>(spec, Dc, 0, false, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_rates<T>(
      tb, pl, spec,
      RatesCall<T>{static_cast<const T*>(nhi), static_cast<const T*>(rt),
                   static_cast<const T*>(bins_s), static_cast<const T*>(bins_w),
                   static_cast<const T*>(bins_wh), static_cast<const T*>(flux),
                   static_cast<T*>(phi), static_cast<T*>(heat),
                   static_cast<T*>(ci), static_cast<T*>(dc),
                   static_cast<T*>(scratch), E, threads_b,
                   static_cast<T>(s_fac), static_cast<T>(sdr3)});
}

}  // namespace

extern "C" {

// Launches phase A (as clusters, planned by the caller like the sweeps of
// cheb_sweep.cu) then phase B on `stream`; returns the first cudaError_t
// that is not cudaSuccess, else cudaSuccess. With `max_clusters` set it
// launches nothing and writes there how many of phase A's clusters are
// resident at once. `heat` and `bins_wh` are null for K3 and both set for
// K3h. `s_fac` is S* dr / dr^3 and `sdr3` S* / dr^3, both rounded to the
// element type by the caller.
#define CHEB_SWEEP_RATES_ENTRY(NAME, TYPE)                                     \
  int NAME(const void* nhi, const void* sw, const void* path,                 \
           const void* diag, const void* mask_m, const void* mask_p,          \
           const void* rt, const void* bins_s, const void* bins_w,            \
           const void* bins_wh, const void* flux, void* phi, void* heat,      \
           void* ci, void* dc, void* scratch, int E, double s_fac,            \
           double sdr3, int threads_b, int B, int Dc, int c, int R1,          \
           double dr, double sig, int threads, int cluster,                   \
           int shared_planes, int smem, int rate_threads, int ring,           \
           int* max_clusters, void* stream) {                                 \
    return launch<TYPE>(nhi, sw, path, diag, mask_m, mask_p, rt, bins_s,      \
                        bins_w, bins_wh, flux, phi, heat, ci, dc, scratch, E, \
                        s_fac, sdr3, threads_b, Dc, c, R1, dr, sig,           \
                        LaunchSpec{B, threads, cluster, shared_planes, smem,  \
                                   rate_threads, ring, max_clusters,          \
                                   stream});                                  \
  }

CHEB_SWEEP_RATES_ENTRY(cheb_sweep_rates_f32, float)
CHEB_SWEEP_RATES_ENTRY(cheb_sweep_rates_f64, double)

const char* cheb_sweep_rates_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
