// Chebyshev-face column-density sweep for NVIDIA Hopper (sm_90a): three
// entry points over the sweep of cheb_sweep.cuh. Plain versions:
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

#include "cheb_sweep.cuh"

namespace {

using namespace cheb;

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

// `n` cluster barriers and nothing else: what one link of the sweep's chain
// costs at the least (timed by chip_smoke.py).
__global__ void cluster_barriers_kernel(int n) {
  for (int i = 0; i < n; ++i) {
    cluster_arrive();
    cluster_wait();
  }
}

// out[i] = sum_e w_e exp(-tau_in[i] s_e) (-expm1(-dtau[i] s_e)) over n cells
// and nothing else: what the bins of one cell cost where nothing waits for
// them (timed by chip_smoke.py for the rate floor of K1f, K3 and K3h).
template <typename T>
__global__ void bin_sums_kernel(const T* __restrict__ tau_in,
                                const T* __restrict__ dtau,
                                const T* __restrict__ bins_s,
                                const T* __restrict__ bins_w, int E, size_t n,
                                T* out) {
  T* bins = shared_mem<T>();
  load_bins(bins_s, bins_w, E, bins);
  const size_t step = size_t(gridDim.x) * blockDim.x;
  size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i < n; i += step)
    out[i] = bin_sum(tau_in[i], dtau[i], bins, E);
}

// The launches of the three kernels for one element type.
template <typename T>
struct Entry {
  static int sweep(const Tables<T>& tb, const LaunchSpec& spec, const void* nhi,
                   void* box, void* scratch) {
    Plan pl;
    const cudaError_t err = make_plan<T>(spec, tb.Dc, 0, false, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_cluster(
        pl.rows ? cheb_sweep_kernel<T, true> : cheb_sweep_kernel<T, false>,
        spec, tb, pl, static_cast<const T*>(nhi), static_cast<T*>(box),
        static_cast<T*>(scratch));
  }

  static int gamma(const Tables<T>& tb, const LaunchSpec& spec, const void* nhi,
                   const void* rt, const void* flux, const void* bins_s,
                   const void* bins_w, int E, double R2, double sdr3,
                   void* box, void* scratch) {
    Plan pl;
    const cudaError_t err = make_plan<T>(spec, tb.Dc, 2 * E, true, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_cluster(
        pl.rows ? cheb_sweep_gamma_kernel<T, true>
                : cheb_sweep_gamma_kernel<T, false>,
        spec, tb, pl, static_cast<const T*>(nhi), static_cast<const T*>(rt),
        static_cast<const T*>(flux), static_cast<const T*>(bins_s),
        static_cast<const T*>(bins_w), E, static_cast<T>(R2), static_cast<T>(sdr3), static_cast<T*>(box),
        static_cast<T*>(scratch));
  }

  static int seg(const Tables<T>& tb, const LaunchSpec& spec, const void* nhi,
                 const void* planes_in, void* planes_out, int r0, int r1,
                 void* box, void* scratch) {
    Plan pl;
    const cudaError_t err = make_plan<T>(spec, tb.Dc, 0, false, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_cluster(
        pl.rows ? cheb_sweep_seg_kernel<T, true>
                : cheb_sweep_seg_kernel<T, false>,
        spec, tb, pl, static_cast<const T*>(nhi),
        static_cast<const T*>(planes_in), static_cast<T*>(planes_out), r0, r1,
        static_cast<T*>(box), static_cast<T*>(scratch));
  }
};

}  // namespace

// The arguments every entry point starts and ends with: the sweep's inputs,
// and the launch as the caller planned it (LaunchSpec, in its order).
#define CHEB_IN_ARGS                                                          \
  const void *nhi, const void *sw, const void *path, const void *diag,      \
      const void *mask_m, const void *mask_p
#define CHEB_LAUNCH_ARGS                                                      \
  int B, int Dc, int c, int R1, double dr, double sig, int threads,         \
      int cluster, int shared_planes, int smem, int rate_threads, int ring,  \
      int *max_clusters, void *stream
#define CHEB_TABLES(T)                                                        \
  make_tables<T>(sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig)
#define CHEB_SPEC                                                             \
  LaunchSpec { B, threads, cluster, shared_planes, smem, rate_threads, ring, \
               max_clusters, stream }

extern "C" {

// Each entry point launches on `stream` and returns the cudaError_t of the
// launch (0: launched), or with `max_clusters` set launches nothing and
// writes there how many clusters of that launch are resident at once.
#define CHEB_SWEEP_ENTRIES(SFX, T)                                            \
  int cheb_sweep_##SFX(CHEB_IN_ARGS, void* box, void* scratch,                \
                       CHEB_LAUNCH_ARGS) {                                    \
    return Entry<T>::sweep(CHEB_TABLES(T), CHEB_SPEC, nhi, box, scratch);     \
  }                                                                           \
  int cheb_sweep_gamma_##SFX(CHEB_IN_ARGS, const void* rt, const void* flux,  \
                             const void* bins_s, const void* bins_w,          \
                             void* box, void* scratch, int E, double R2,      \
                             double sdr3, CHEB_LAUNCH_ARGS) {                 \
    return Entry<T>::gamma(CHEB_TABLES(T), CHEB_SPEC, nhi, rt, flux, bins_s,  \
                           bins_w, E, R2, sdr3, box, scratch);                \
  }                                                                           \
  int cheb_sweep_seg_##SFX(CHEB_IN_ARGS, const void* planes_in,               \
                           void* planes_out, void* box, void* scratch,        \
                           int r0, int r1, CHEB_LAUNCH_ARGS) {                \
    return Entry<T>::seg(CHEB_TABLES(T), CHEB_SPEC, nhi, planes_in,           \
                         planes_out, r0, r1, box, scratch);                   \
  }

CHEB_SWEEP_ENTRIES(f32, float)
CHEB_SWEEP_ENTRIES(f64, double)

// `n` barriers in each of B clusters of `cluster` blocks.
int cheb_cluster_barriers(int B, int threads, int cluster, int n,
                          void* stream) {
  return launch_cluster(cluster_barriers_kernel,
                        LaunchSpec{B, threads, cluster, 0, 0, 0, 0, nullptr,
                                   stream},
                        n);
}

// The dense pass of bin_sums_kernel over n cells, `blocks` x `threads`.
#define CHEB_BIN_SUMS_ENTRY(SFX, T)                                           \
  int cheb_bin_sums_##SFX(const void* tau_in, const void* dtau,               \
                          const void* bins_s, const void* bins_w, void* out,  \
                          int E, long long n, int blocks, int threads,        \
                          void* stream) {                                     \
    bin_sums_kernel<T><<<blocks, threads, 2 * E * sizeof(T),                  \
                         static_cast<cudaStream_t>(stream)>>>(                \
        static_cast<const T*>(tau_in), static_cast<const T*>(dtau),           \
        static_cast<const T*>(bins_s), static_cast<const T*>(bins_w), E,      \
        static_cast<size_t>(n), static_cast<T*>(out));                        \
    return static_cast<int>(cudaGetLastError());                              \
  }

CHEB_BIN_SUMS_ENTRY(f32, float)
CHEB_BIN_SUMS_ENTRY(f64, double)

const char* cheb_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
