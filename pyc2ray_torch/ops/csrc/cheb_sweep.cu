// Chebyshev-face column-density sweep for NVIDIA Hopper (sm_90a): the entry
// points of K1, K1f, K2 and the start of a segmented sweep. Plain versions:
// pyc2ray_torch/ops/sweep.py.
//
// The kernels (K1, K1f, K2, and the start of a segmented sweep) and their
// launches live in cheb_sweep_kernels.cuh, shared with the batch loop of
// trace_loop.cu; its head says what each replaces, its design and its
// bound. Here: the entry points, and two kernels that only time the card
// (the cost of a cluster barrier, a dense pass of the bin sums).

#include "cheb_sweep_kernels.cuh"

namespace {

using namespace cheb;

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

// The entry points' plans: make_plan checks the caller's sizes, then the
// launch of cheb_sweep_kernels.cuh.
template <typename T>
struct Entry {
  static int sweep(const Tables<T>& tb, const LaunchSpec& spec, const void* nhi,
                   void* box, void* scratch) {
    Plan pl;
    const cudaError_t err = make_plan<T>(spec, tb.Dc, 0, false, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_sweep(tb, pl, spec, static_cast<const T*>(nhi),
                        static_cast<T*>(box), static_cast<T*>(scratch));
  }

  static int gamma(const Tables<T>& tb, const LaunchSpec& spec, const void* nhi,
                   const void* rt, const void* flux, const void* bins_s,
                   const void* bins_w, int E, double R2, double sdr3,
                   void* box, void* scratch) {
    Plan pl;
    const cudaError_t err = make_plan<T>(spec, tb.Dc, 2 * E, true, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_gamma(tb, pl, spec, static_cast<const T*>(nhi),
                        static_cast<const T*>(rt), static_cast<const T*>(flux),
                        static_cast<const T*>(bins_s),
                        static_cast<const T*>(bins_w), E, static_cast<T>(R2),
                        static_cast<T>(sdr3), static_cast<T*>(box),
                        static_cast<T*>(scratch));
  }

  static int seg(const Tables<T>& tb, const LaunchSpec& spec, const void* nhi,
                 const void* planes_in, void* planes_out, int r0, int r1,
                 void* box, void* scratch) {
    Plan pl;
    const cudaError_t err = make_plan<T>(spec, tb.Dc, 0, false, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_seg(tb, pl, spec, static_cast<const T*>(nhi),
                      static_cast<const T*>(planes_in),
                      static_cast<T*>(planes_out), r0, r1,
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

// The start of a segmented sweep of B boxes (init_segments_kernel): the
// (B, Dc, Dc, Dc) box and the (B, 3, 2, Dc, Dc) planes of shell 0, on
// `stream`.
#define CHEB_INIT_SEGMENTS_ENTRY(SFX, T)                                      \
  int cheb_init_segments_##SFX(const void* nhi, void* box, void* planes,     \
                               int B, int Dc, int c, double dr,              \
                               void* stream) {                               \
    return launch_init_segments<T>(static_cast<const T*>(nhi),                \
                                   static_cast<T*>(box),                     \
                                   static_cast<T*>(planes), B, Dc, c,         \
                                   static_cast<T>(dr),                       \
                                   static_cast<cudaStream_t>(stream));        \
  }

CHEB_INIT_SEGMENTS_ENTRY(f32, float)
CHEB_INIT_SEGMENTS_ENTRY(f64, double)

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
