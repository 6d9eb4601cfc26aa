// The Chebyshev-face column-density sweep kernels for NVIDIA Hopper
// (sm_90a) over the sweep of cheb_sweep.cuh, their launches and the start
// of a segmented sweep. Entered by cheb_sweep.cu (one call each) and by
// trace_loop.cu (the batch loop of a whole trace). Plain versions:
// pyc2ray_torch/ops/sweep.py.
//
// K1   cheb_sweep_f32/f64 replaces pyc2ray_tpu/ops/pallas_sweep.py::
//      cheb_sweep_pallas with bins=None (body _kernel, _shell_update,
//      _face_update), followed by the stack-to-box fold of
//      raytrace_cheb.py::_fold_stacks_packed. It writes the coldensh_out
//      box; the source cell gets nHI_c * dr / 2.
// K1f  cheb_sweep_gamma_f32/f64 replaces the same kernel with static bins
//      (_kernel's fused rate pass, fuse_rates=True) and what the engine did
//      to its output afterwards. It writes, in place of the cd, the Gamma
//      of every valid face cell
//        flux S*/(dr^3 4 pi d2 path max(nHI, tiny)) sum_e w_e e^{-tau_in s_e}
//        (-expm1(-dtau s_e)),  masked by d2 <= R^2 and cdin <= 2e30,
//      with d2 the cell's true squared distance (the dist2 channel of the
//      rates table at its cartesian position), and the source cell's closed
//      form (source_rate). The planes still carry the cd. The bins are
//      evaluated by rate threads, off the chain (cheb_sweep.cuh). Two
//      faults of the TPU kernel are not copied: it divides by nHI without
//      a floor (0/0 at a zero-density cell), and its d2 comes from the
//      plane min(c+r, Dc-1) for both signs, which is wrong for the minus
//      face of a clipped box.
// K2   cheb_sweep_seg_f32/f64 replaces cheb_sweep_seg_pallas (_kernel_seg):
//      shells r0 .. r1-1 from the carried planes of shell r0-1, storing
//      their face cells into a box the caller zeroed once, and handing the
//      last shell's planes back. It is K1's loop with a shell range and an
//      in/out plane buffer; the TPU segment stacks and their fold have no
//      counterpart, since the kernel stores the cartesian box directly.
//
// Design. The TPU kernel's lane packing, rolls and masked-select stitches
// are register devices of that machine and are not copied: a thread
// computes the stitched stencil value of any plane cell by a direct lookup
// in the r-1 planes (and the same shell's x/y planes), with the stitch
// precedence of the reference written as an if-chain. The loop over the
// shells is struct Sweep of cheb_sweep.cuh, shared by all kernels: a
// thread-block cluster per source (grid B x C, the cluster's blocks dealing
// out each sub-step's shell window evenly), one hardware cluster barrier
// per sub-step, the 12 planes of shells r-1 and r in the cluster's
// distributed shared memory where 12 ceil(Dc/C) Dc values fit (else in a
// global scratch through L2). The operands that do not depend on the chain
// (corner weights, diag, path, nHI) are loaded where they are used; staging
// them ahead by cp.async was built, measured slower on the H100 and taken
// out (PERF.md). C and the placement are chosen on the host by
// ops/sweep.py::sweep_plan from (B, Dc, dtype) and
// cudaOccupancyMaxActiveClusters; a launch the card refuses returns its
// error and nothing runs in its place. K1f keeps the
// spectral bins at the start of shared memory, loaded once per block, and
// the ring of its deferred cells behind the planes.
//
// Bound. Each reads the nHI box and the geometry tables once and writes
// one box: at B = 8, Dc = 64, R1 = 31 in f32, 8 MB + 10 MB + 8 MB, about
// 8 us at 3.35 TB/s. K1's arithmetic (~27 flops per face cell) is below
// that; K1f adds 2 transcendentals and ~5 flops per bin and valid cell
// (its rate floor: valid cells x bins x the card's measured time per cell
// and bin of a dense pass, PERF.md). The byte bound leaves out the
// chain: 3 (R1 - 1) sub-steps follow each other, each at least one cluster
// barrier and one read-compute-write of the planes, so the floor of this
// algorithm is 3 (R1 - 1) times the barrier's cost (PERF.md has both). What
// is left above that floor: a sub-step's loads (an L2 hit for the operands
// and the mask, a remote shared-memory read for the planes), five
// dependent divisions and the barrier's release; the z faces read nHI and
// store the box with stride Dc (one 32-byte sector per value).
//
// init_segments_kernel starts a shell-segmented sweep (K2 over segments of
// shells): shell 0's planes (zero, the source cell of every face and sign
// at nHI_c dr / 2) and the box, zero but the source cell at the same column.
// K2 stores only face cells of shells r >= 1, never the source cell, so the
// box holds the column from the start where the plain version sets it after
// the last segment. In the JAX engine this is XLA code around the segments
// (_sweep_pallas_segmented), no TPU kernel. Bound: it writes B (Dc^3 +
// 6 Dc^2) values and reads B, nothing else; one block per box plane.

#pragma once

#include "cheb_sweep.cuh"

namespace cheb {

// K1 and K2: keep the cd of a valid face cell, inside the sub-step.
template <typename T>
struct KeepCd {
  static constexpr bool kDeferred = false;
  T* box;
  __device__ void operator()(const FaceCell<T>& f) const { box[f.o] = f.out; }
};

// K1f: keep the Gamma of a valid face cell in a box of zeros, off the chain.
template <typename T>
struct KeepGamma {
  static constexpr bool kDeferred = true;
  T* box;
  const T* rt;          // (Dc, 2, Dc, Dc): dist2, valid
  const T* bins;        // shared memory: s[E], w[E]
  int E, Dc;
  T R2, sdr3;           // R^2; S* / dr^3
  T sig, flux;
  __device__ void operator()(const FaceCell<T>& f) const {
    using A = Arith<T>;
    const size_t D2 = size_t(Dc) * Dc;
    const T d2 = rt[f.o + (f.o / D2) * D2];            // channel 0 of plane i
    if (d2 <= R2 && f.cdin <= T(kMaxColdensH)) {
      const T acc = bin_sum(A::mul(f.cdin, sig), A::mul(f.dcol, sig), bins, E);
      const T pref = A::div(sdr3, A::mul(A::mul(d2, f.path), T(kFourPi)));
      const T g = A::div(A::mul(pref, acc), max_lim(Arith<T>::tiny, f.nhi));
      box[f.o] = A::mul(g, flux);
    }
  }
};

template <typename T, bool SH>
__global__ void cheb_sweep_kernel(Tables<T> tb, Plan pl,
                                  const T* __restrict__ nhi_all, T* box_all,
                                  T* scratch_all) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc, D3 = D2 * tb.Dc;
  const size_t src = blockIdx.x >> pl.lgC;
  const T* nhi = nhi_all + src * D3;
  T* box = box_all + src * D3;
  const Sweep<T, SH> sweep(tb, pl, nhi, SH ? nullptr : scratch_all + src * 12 * D2);
  const T src_cd = source_cd(tb, nhi);
  sweep.fill_zero(box, D3);
  sweep.init(nullptr, 0, src_cd);
  sweep.run(1, tb.R1, KeepCd<T>{box});
  if (sweep.rank == 0 && threadIdx.x == 0)
    box[(size_t(tb.c) * tb.Dc + tb.c) * tb.Dc + tb.c] = src_cd;
}

template <typename T, bool SH>
__global__ void __launch_bounds__(kMaxThreads)
cheb_sweep_gamma_kernel(Tables<T> tb, Plan pl, const T* __restrict__ nhi_all,
                        const T* __restrict__ rt,
                        const T* __restrict__ flux_all,
                        const T* __restrict__ bins_s,
                        const T* __restrict__ bins_w, int E, T R2, T sdr3,
                        T* box_all, T* scratch_all) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc, D3 = D2 * tb.Dc;
  const size_t src = blockIdx.x >> pl.lgC;
  const T* nhi = nhi_all + src * D3;
  T* box = box_all + src * D3;
  const T flux = flux_all[src];
  T* bins = shared_mem<T>();
  load_bins(bins_s, bins_w, E, bins);
  const Sweep<T, SH> sweep(tb, pl, nhi, SH ? nullptr : scratch_all + src * 12 * D2);
  const T src_cd = source_cd(tb, nhi);
  // the source cell's closed form: by the block's last thread, ahead of
  // the chain, stored after it
  const size_t centre = (size_t(tb.c) * tb.Dc + tb.c) * tb.Dc + tb.c;
  const bool last = sweep.rank == 0 && threadIdx.x == blockDim.x - 1;
  T src_rate = T(0);
  if (last)
    src_rate = source_rate(nhi[centre], src_cd, flux, sdr3, tb.sig, bins,
                           bins + E, E);
  sweep.fill_zero(box, D3);
  sweep.init(nullptr, 0, src_cd);
  sweep.run(1, tb.R1,
            KeepGamma<T>{box, rt, bins, E, tb.Dc, R2, sdr3, tb.sig, flux});
  if (last) box[centre] = src_rate;
}

template <typename T, bool SH>
__global__ void cheb_sweep_seg_kernel(Tables<T> tb, Plan pl,
                                      const T* __restrict__ nhi_all,
                                      const T* __restrict__ planes_in,
                                      T* planes_out, int r0, int r1,
                                      T* box_all, T* scratch_all) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc, D3 = D2 * tb.Dc;
  const size_t src = blockIdx.x >> pl.lgC;
  const Sweep<T, SH> sweep(tb, pl, nhi_all + src * D3,
                           SH ? nullptr : scratch_all + src * 12 * D2);
  sweep.init(planes_in + src * 6 * D2, (r0 - 1) & 1, T(0));
  sweep.run(r0, r1, KeepCd<T>{box_all + src * D3});
  sweep.export_planes(planes_out + src * 6 * D2, (max(r1, r0) - 1) & 1);
}

// One block per plane i of box b: the box plane zeroed but the source cell,
// and planes i, i + Dc, ... of the six of shell 0 (face, sign) zeroed but
// their source cell; that cell at nHI_c dr / 2 (as source_cd).
template <typename T>
__global__ void init_segments_kernel(const T* __restrict__ nhi_all, T* box_all,
                                     T* planes_all, int Dc, int c, T dr) {
  using A = Arith<T>;
  const int b = blockIdx.x / Dc, i = blockIdx.x % Dc;
  const size_t D2 = size_t(Dc) * Dc, D3 = D2 * Dc;
  const size_t centre = size_t(c) * Dc + c;               // (c, c) of a plane
  const T cd = A::mul(nhi_all[b * D3 + size_t(c) * D2 + centre],
                      A::mul(T(0.5), dr));
  T* box = box_all + b * D3 + size_t(i) * D2;
  for (size_t jk = threadIdx.x; jk < D2; jk += blockDim.x)
    box[jk] = i == c && jk == centre ? cd : T(0);
  for (int p = i; p < 6; p += Dc) {
    T* plane = planes_all + (size_t(b) * 6 + p) * D2;
    for (size_t jk = threadIdx.x; jk < D2; jk += blockDim.x)
      plane[jk] = jk == centre ? cd : T(0);
  }
}

// The launches of the four kernels, with a plan that make_plan made from the
// caller's LaunchSpec (with spec.max_clusters only the question how many of
// the clusters fit). Each returns the first cudaError_t that is not
// cudaSuccess.

constexpr int kInitThreads = 256;   // threads per block of init_segments

template <typename T>
int launch_sweep(const Tables<T>& tb, const Plan& pl, const LaunchSpec& spec,
                 const T* nhi, T* box, T* scratch) {
  return launch_cluster(
      pl.rows ? cheb_sweep_kernel<T, true> : cheb_sweep_kernel<T, false>,
      spec, tb, pl, nhi, box, scratch);
}

template <typename T>
int launch_gamma(const Tables<T>& tb, const Plan& pl, const LaunchSpec& spec,
                 const T* nhi, const T* rt, const T* flux, const T* bins_s,
                 const T* bins_w, int E, T R2, T sdr3, T* box, T* scratch) {
  return launch_cluster(
      pl.rows ? cheb_sweep_gamma_kernel<T, true>
              : cheb_sweep_gamma_kernel<T, false>,
      spec, tb, pl, nhi, rt, flux, bins_s, bins_w, E, R2, sdr3, box, scratch);
}

template <typename T>
int launch_seg(const Tables<T>& tb, const Plan& pl, const LaunchSpec& spec,
               const T* nhi, const T* planes_in, T* planes_out, int r0, int r1,
               T* box, T* scratch) {
  return launch_cluster(
      pl.rows ? cheb_sweep_seg_kernel<T, true>
              : cheb_sweep_seg_kernel<T, false>,
      spec, tb, pl, nhi, planes_in, planes_out, r0, r1, box, scratch);
}

template <typename T>
int launch_init_segments(const T* nhi, T* box, T* planes, int B, int Dc,
                         int c, T dr, cudaStream_t st) {
  if (B < 1 || Dc < 1 || c < 0 || c >= Dc) return cudaErrorInvalidValue;
  init_segments_kernel<T><<<B * Dc, kInitThreads, 0, st>>>(nhi, box, planes,
                                                            Dc, c, dr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cheb
