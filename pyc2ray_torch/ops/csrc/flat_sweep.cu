// The flat engine's trace on NVIDIA Hopper (sm_90a): the launches of the
// kernels of flat_sweep.cuh (the gather, the sweep, the rate pass and the
// ordered accumulate of ops/raytrace.py's Raytracer) and the loop that
// issues a whole trace from the host side of the library:
//
//   trace  per device batch (`dev_batch` consecutive sources) gather ->
//          sweep -> rates, then the accumulate a batch of B at a time, on
//          one stream, nothing synchronizing with the host.
//
// The launch code makes blocks of 1024 threads at one block per SM for the
// sweep; the caller picks its cluster size C and the placement of its
// column densities (ops/flat_sweep.py::flat_plan): the largest cluster of
// which all B fit on the card at once. The gather runs a block of kThreads
// threads per gather block and source, the rate pass a thread per rated
// cell and source, the accumulate a thread per cell and source.

#include "flat_sweep.cuh"

namespace flat {

// The launches of the flat kernels

template <typename T>
int launch_gather(const Geom<T>& g, const T* nhi, const int* pos, T* out,
                  int B, cudaStream_t st) {
  const int smem = int(gather_smem(g));
  if (smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t err = cheb::allow(
      reinterpret_cast<const void*>(flat_gather_kernel<T>), smem, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  flat_gather_kernel<T><<<dim3(g.n_blk, B), kThreads, smem, st>>>(g, nhi,
                                                                  pos, out);
  return static_cast<int>(cudaGetLastError());
}

// B clusters of `cluster` blocks of kSweepThreads threads, the column
// densities in the ring (RING) or in global memory (or, with max_clusters,
// only ask how many of them the card holds at once).
template <typename T, bool RING>
int launch_sweep_form(const Geom<T>& g, const T* nhi, const int* pos,
                      const T* nhi_octa, T* cd, int B, int cluster,
                      int* max_clusters, cudaStream_t st) {
  int lgC = 0;
  while ((1 << lgC) < cluster) ++lgC;
  if (cluster < 1 || cluster > kChunks || (1 << lgC) != cluster)
    return cudaErrorInvalidValue;
  const int smem = RING ? ring_bytes(g, cluster) : 0;
  if ((RING && (g.depth - 1) * (kChunks / cluster) * g.max_u >= (1 << 24)) ||
      smem > 232448)
    return cudaErrorInvalidValue;
  const cheb::LaunchSpec spec{B, kSweepThreads, cluster, 0, smem, 0, 0,
                              max_clusters, st};
  return cheb::launch_cluster(flat_sweep_kernel<T, RING>, spec, g, nhi, pos,
                              nhi_octa, cd, lgC);
}

// The engine's sweep: the ring (shared) or global placement.
template <typename T>
int launch_sweep(const Geom<T>& g, const T* nhi, const int* pos,
                 const T* nhi_octa, T* cd, int B, int cluster, bool shared,
                 int* max_clusters, cudaStream_t st) {
  return shared ? launch_sweep_form<T, true>(g, nhi, pos, nhi_octa, cd, B,
                                             cluster, max_clusters, st)
                : launch_sweep_form<T, false>(g, nhi, pos, nhi_octa, cd, B,
                                              cluster, max_clusters, st);
}

// The rate pass of the rated cells; the outputs' unrated cells are left as
// they are (the caller zeroes them).
template <typename T>
int launch_rates(const Geom<T>& g, const RateIO<T>& a, cudaStream_t st) {
  const dim3 grid((g.n_rated + kThreads - 1) / kThreads, a.B);
  if (g.grey)
    flat_rates_kernel<T, true, false><<<grid, kThreads, 0, st>>>(g, a);
  else if (a.heat)
    flat_rates_kernel<T, false, true><<<grid, kThreads, 0, st>>>(g, a);
  else
    flat_rates_kernel<T, false, false><<<grid, kThreads, 0, st>>>(g, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_accumulate(const Geom<T>& g, const AccIO<T>& a, cudaStream_t st) {
  const dim3 grid((g.C + kThreads - 1) / kThreads, a.B);
  const size_t smem = sizeof(int) * (size_t(a.B) + 1);     // the near list
  if (a.heat)
    flat_accumulate_kernel<T, true><<<grid, kThreads, smem, st>>>(g, a);
  else
    flat_accumulate_kernel<T, false><<<grid, kThreads, smem, st>>>(g, a);
  return static_cast<int>(cudaGetLastError());
}

// The trace of ns sources, `dev_batch` of them at a time (consecutive
// sources in source order; the clusters the card holds at once): the rate
// scratch zeroed once (the rate pass writes only the rated cells), then per
// device batch the gather, the sweep and the rate pass, then the ordered
// accumulate `acc_batch` sources at a time in source order, so every grid
// cell takes its adds in source order as the plain loop's batches give
// them. On `st`; returns the first error; a refused launch never runs.
template <typename T>
int trace(const Geom<T>& g, const Trace<T>& tr, int ns, int dev_batch,
          int acc_batch, int cluster, bool shared, cudaStream_t st) {
  if (dev_batch < 1 || acc_batch < 1) return cudaErrorInvalidValue;
  const size_t scratch = size_t(dev_batch) * g.C * sizeof(T);
  cudaError_t err = cudaMemsetAsync(tr.phi, 0, scratch, st);
  if (err == cudaSuccess && tr.heat)
    err = cudaMemsetAsync(tr.heat, 0, scratch, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int s = 0; s < ns; s += dev_batch) {
    const int n = min(dev_batch, ns - s);          // sources of this batch
    Trace<T> c = tr;
    c.B = n;
    c.pos = tr.pos + size_t(3) * s;
    c.flux = tr.flux + s;
    int rc = launch_gather<T>(g, c.nhi, c.pos, c.nhi_octa, n, st);
    if (rc == 0)
      rc = launch_sweep<T>(g, c.nhi, c.pos, c.nhi_octa, c.cd, n, cluster,
                           shared, nullptr, st);
    if (rc == 0) rc = launch_rates<T>(g, c.rates(0), st);
    for (int a = 0; rc == 0 && a < n; a += acc_batch) {
      const size_t at = size_t(a) * g.C;
      const AccIO<T> io{c.pos + size_t(3) * a, c.phi + at,
                        c.heat ? c.heat + at : nullptr, c.phi_grid,
                        c.heat_grid, min(acc_batch, n - a)};
      rc = launch_accumulate<T>(g, io, st);
    }
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace flat

extern "C" {

// The entry points take the engine's tables as `tabs` (flat::kTabs
// pointers), `dims` (flat::kDims ints) and `vals` (4 doubles) in
// make_geom's order, and return the first cudaError_t that is not
// cudaSuccess (an invalid size is cudaErrorInvalidValue, nothing launched).
//
// flat_gather: nHI of the octahedra of the B sources at pos (B, 3), int32
// in [0, N) (ops/flat_sweep.py::stage_positions), from the grid nhi (N^3)
// into out (B, C).
// flat_sweep: the gather into nhi_octa (B, C), then the sweep of those
// sources over it into cd (B, C), as B clusters
// of `cluster` blocks of kSweepThreads threads with the column densities
// in the shared ring (`shared`) or in global memory; with max_clusters set,
// launches nothing and writes there how many of those clusters are
// resident at once.
// flat_rates: the rate pass of those sources from their gathered nHI
// nhi_octa and their column densities cd (B, C), with the fluxes flux (B,)
// and S* / dr^3 at sdr3 (on the device), into the rated cells of phi (and
// heat, where it is set) (B, C); their other cells are left as they are.
// flat_accumulate: adds phi (and heat) of those sources into phi_grid (and
// heat_grid), source after source.
// flat_trace_sweep: the trace of ns sources (pos (ns, 3), flux (ns,)),
// dev_batch of them a device batch: per device batch the gather, the sweep
// and the rate pass, then the accumulate acc_batch sources at a time, with
// nhi_octa, cd, phi and heat (dev_batch, C) as scratch.
#define FLAT_ENTRIES(SFX, TYPE)                                                \
  int flat_gather_##SFX(void* const* tabs, const int* dims,                    \
                        const double* vals, const void* nhi, const int* pos,   \
                        void* out, int B, void* stream) {                      \
    const flat::Geom<TYPE> g = flat::make_geom<TYPE>(tabs, dims, vals);        \
    if (!flat::fits(g, B, false)) return cudaErrorInvalidValue;                \
    return flat::launch_gather<TYPE>(g, static_cast<const TYPE*>(nhi), pos,    \
                                     static_cast<TYPE*>(out), B,               \
                                     static_cast<cudaStream_t>(stream));       \
  }                                                                            \
  int flat_sweep_##SFX(void* const* tabs, const int* dims,                     \
                       const double* vals, const void* nhi,                    \
                       const int* pos, void* nhi_octa, void* cd, int B,        \
                       int cluster, int shared, int* max_clusters,             \
                       void* stream) {                                         \
    const flat::Geom<TYPE> g = flat::make_geom<TYPE>(tabs, dims, vals);        \
    if (!flat::fits(g, B, false)) return cudaErrorInvalidValue;                \
    const auto st = static_cast<cudaStream_t>(stream);                         \
    using P = const TYPE*;                                                     \
    if (max_clusters == nullptr) {                                             \
      const int rc = flat::launch_gather<TYPE>(                                \
          g, static_cast<P>(nhi), pos, static_cast<TYPE*>(nhi_octa), B, st);   \
      if (rc != 0) return rc;                                                  \
    }                                                                          \
    return flat::launch_sweep<TYPE>(                                           \
        g, static_cast<P>(nhi), pos, static_cast<P>(nhi_octa),                 \
        static_cast<TYPE*>(cd), B, cluster, shared != 0, max_clusters, st);    \
  }                                                                            \
  int flat_rates_##SFX(void* const* tabs, const int* dims,                     \
                       const double* vals, const void* nhi_octa,               \
                       const void* flux, const void* sdr3, const void* cd,     \
                       void* phi, void* heat, int B, void* stream) {           \
    const flat::Geom<TYPE> g = flat::make_geom<TYPE>(tabs, dims, vals);        \
    if (!flat::fits(g, B, heat != nullptr)) return cudaErrorInvalidValue;      \
    using P = const TYPE*;                                                     \
    const flat::RateIO<TYPE> a{static_cast<P>(nhi_octa), static_cast<P>(flux), \
                               static_cast<P>(sdr3), static_cast<P>(cd),       \
                               static_cast<TYPE*>(phi),                        \
                               static_cast<TYPE*>(heat), B};                   \
    return flat::launch_rates<TYPE>(g, a, static_cast<cudaStream_t>(stream));  \
  }                                                                            \
  int flat_accumulate_##SFX(void* const* tabs, const int* dims,                \
                            const double* vals, const int* pos,                \
                            const void* phi, const void* heat,                 \
                            void* phi_grid, void* heat_grid, int B,            \
                            void* stream) {                                    \
    const flat::Geom<TYPE> g = flat::make_geom<TYPE>(tabs, dims, vals);        \
    if (!flat::fits(g, B, heat != nullptr) ||                                  \
        (heat == nullptr) != (heat_grid == nullptr))                           \
      return cudaErrorInvalidValue;                                            \
    using P = const TYPE*;                                                     \
    const flat::AccIO<TYPE> a{pos, static_cast<P>(phi), static_cast<P>(heat),  \
                              static_cast<TYPE*>(phi_grid),                    \
                              static_cast<TYPE*>(heat_grid), B};               \
    return flat::launch_accumulate<TYPE>(g, a,                                 \
                                         static_cast<cudaStream_t>(stream));   \
  }                                                                            \
  int flat_trace_sweep_##SFX(                                                  \
      void* const* tabs, const int* dims, const double* vals,                  \
      const void* nhi, const int* pos, const void* flux,                       \
      const void* sdr3, void* nhi_octa, void* cd, void* phi, void* heat,       \
      void* phi_grid, void* heat_grid, int ns, int dev_batch, int acc_batch,   \
      int cluster, int shared, void* stream) {                                 \
    const flat::Geom<TYPE> g = flat::make_geom<TYPE>(tabs, dims, vals);        \
    if (!flat::fits(g, dev_batch, heat != nullptr) || ns < 0 ||                \
        (heat == nullptr) != (heat_grid == nullptr))                           \
      return cudaErrorInvalidValue;                                            \
    using P = const TYPE*;                                                     \
    const flat::Trace<TYPE> tr{static_cast<P>(nhi), pos,                       \
                               static_cast<P>(flux), static_cast<P>(sdr3),     \
                               static_cast<TYPE*>(nhi_octa),                   \
                               static_cast<TYPE*>(cd),                         \
                               static_cast<TYPE*>(phi),                        \
                               static_cast<TYPE*>(heat),                       \
                               static_cast<TYPE*>(phi_grid),                   \
                               static_cast<TYPE*>(heat_grid), dev_batch};      \
    return flat::trace<TYPE>(g, tr, ns, dev_batch, acc_batch, cluster,         \
                             shared != 0,                                      \
                             static_cast<cudaStream_t>(stream));               \
  }

FLAT_ENTRIES(f32, float)
FLAT_ENTRIES(f64, double)

const char* flat_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
