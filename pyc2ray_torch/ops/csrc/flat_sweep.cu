// The flat engine's trace on NVIDIA Hopper (sm_90a): the octahedral shell
// sweep, the rate pass and the ordered accumulate of ops/raytrace.py's
// Raytracer, and the loop that issues a whole trace from the host side of
// the library.
//
// Counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
// raytrace.py::Raytracer._trace_jit: the lax.fori_loop over each shell
// bucket of _sweep (:172-209), the dense _rates (:224-283) and the lax.scan
// over batches with its scatter-add (:288-313)), which XLA runs on the
// device as one program. No TPU kernel of its own: the JAX engine's sweep
// is XLA code. Plain versions: ops/raytrace.py::Raytracer._gather, _sweep,
// _rates and _accumulate; of the loop, ops/flat_sweep.py::
// flat_trace_sweep_ref.
//
//   flat_sweep_kernel       per source, the outgoing HI column density of
//                           every cell of the octahedron (ops/geometry.py's
//                           flat layout), shell after shell; nHI read
//                           straight from the flat grid at each cell's
//                           periodic image.
//   flat_rates_kernel       per (source, cell) the photoionization (and
//                           heating) rate per HI atom: the log-linear
//                           tables or the grey analytic form, and the
//                           MAX_COLDENSH and R_max_LLS masks.
//   flat_accumulate_kernel  adds a batch's B rate octahedra into the flat
//                           grid(s), source after source in batch order.
//   trace                   per batch sweep -> rates -> accumulate on one
//                           stream, nothing synchronizing with the host.
//
// The sweep's design for this card. Shell q's cells read the outgoing
// column densities of earlier shells, so the shells of a source form a
// chain of max_q steps. One thread-block cluster of C blocks works on one
// source (as K1, csrc/cheb_sweep.cuh), and between two shells stands one
// cluster barrier: its arrive releases the shell's stores, its wait
// acquires them. The column densities live in global memory, (B, C) values
// (12.4 MB a bench batch in float64, inside the 50 MB L2), stored and read
// past L1 (st.cg, ld.cg). A shell's cells are dealt out round robin over
// the cluster's C x T threads. The operands of a thread's first cell of a
// shell that do not depend on the chain (four corner indices and weights,
// path, diag, and nHI gathered from the grid) are loaded between the
// barrier's arrive and its wait, so their latency overlaps it. The launch
// code makes blocks of 1024 threads at one block per SM, and the caller
// picks C (ops/flat_sweep.py::flat_plan): the largest cluster of which all
// B fit on the card at once.
//
// Corners. The plain sweep gathers a shell's corners before it writes the
// shell, from a buffer of zeros: a corner in the cell's own shell or a
// later one reads 0 there (they all have weight 0), and here reads 0 without
// a load; a corner of an earlier shell is read whatever its weight, as
// there. The corner sums add ((0 + p0 + p1) + p2) + p3: ATen's reduction
// over a dimension of 4 that is not the innermost (one thread per output,
// its accumulators combined in order) and the CPU's. Only a shell of one
// cell, the far corner of an even mesh's whole box, makes the corners the
// innermost dimension, where ATen's CUDA reduction pairs them; that cell
// has a single corner of nonzero weight (checked for every even N up to
// 4096), so any order gives its bits.
//
// Rounding. Every operation is the one the plain version issues on the
// card, in its order and its type (rounded.cuh: explicitly rounded
// intrinsics, no FMA contraction; log10 and exp the CUDA math functions
// that ATen calls; clamp with ATen's NaN rule). A Python scalar is rounded
// to the type; the division by dlogtau is a multiply by its reciprocal,
// formed in double on the host and rounded to the type, as ATen's div_true
// with a CPU scalar forms it (measured on the card: a reciprocal taken in
// float32 differs in the last bit of some tables' positions); S*/dr^3 is
// read on the device, where the plain version forms it. The result is the
// plain version's bit for bit.
//
// The accumulate's order. The plain version adds each source's rates with
// index_add_, source after source; within one source every grid cell occurs
// once (one periodic image), and index_add_ adds on the card with
// atomicAdd. Octahedra of one batch overlap, so here every grid cell a
// batch covers has one owner: the thread of the lowest source that covers
// it, which finds the covering sources by the offset of the cell from each
// (an inverse table of the clip cube gives the cell's index in a source's
// octahedron) and issues their atomicAdds in ascending source order. So
// every add is the plain version's, in its order, with the same
// instruction (float32's atomicAdd rounds as index_add_'s does).
//
// Bound. The sweep's chain is max_q cluster barriers (52 at the bench
// configuration, 193 at the golden's whole-box octahedron at N = 128); a
// cell reads its 4 corners, its 4 weights, its offsets, path and diag and a
// cell of the grid and writes one value, and does 4 divisions and about 20
// other operations. The rate pass reads the column density, the grid's nHI
// and four values of the tables a cell and writes one or two values; the
// tables' log10 (two or three a cell, six with the heat channel) are its
// most costly operations. The accumulate reads the batch's rates and reads
// and writes the covered cells of the grid. All three move bytes more than
// they compute; chip_smoke.py's flat_work counts them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cheb_sweep.cuh"

namespace flat {

#include "rounded.cuh"

constexpr int kThreads = 256;        // threads per block of the rate pass
                                     // and the accumulate
constexpr int kSweepThreads = 1024;  // threads per block of the sweep
constexpr int kMaxBatch = 4096;      // most sources a batch
constexpr double kTauPhotoLimit = 1.0e-7;   // constants.TAU_PHOTO_LIMIT
constexpr double kMaxColdensH = 2.0e30;     // constants.MAX_COLDENSH

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() {
  return 1.17549435e-38f;                   // torch.finfo(float32).tiny
}
template <> __device__ __forceinline__ double tiny<double>() {
  return 2.2250738585072014e-308;
}

// The engine's tables on the device (ops/raytrace.py::kernel_tables) over
// the C cells of the octahedron, and its scalars in the engine's type.
template <typename T>
struct Geom {
  const int* off;         // (3, C) offsets of the cells from the source
  const int* nbr;         // (4, C) the cells of each cell's corners
  const T* sw;            // (4, C) their geometric weights
  const T* path;          // (C,) path length through the cell, cell units
  const T* diag;          // (C,) diagonal correction
  const T* geom;          // (C,) 1 / (4 pi dist2 path), 1 at the source
  const uint8_t* rated;   // (C,) dist2 <= R_max_LLS^2
  const int* shell;       // (n_shells + 2,) first cell of shell q
  const int* inv;         // (side^3,) the cell of each offset of the clip
                          // cube [lo, lo + side)^3, -1 off the octahedron
  const T* tab[4];        // photo thin, photo thick, heat thin, heat thick
                          // (/ S*; null without tables or heat)
  int C, n_shells, N, max_q, lo, side, num_tau;
  bool grey;              // the grey analytic rates instead of the tables
  T dr, sig, minlogtau, inv_dlogtau;
};

// tabs: off, nbr, sw, path, diag, geom, rated, shell, inv and the four
// tables; dims: C, n_shells, N, max_q, lo, side, num_tau, grey; vals: dr,
// sig, minlogtau, dlogtau.
template <typename T>
Geom<T> make_geom(void* const* tabs, const int* dims, const double* vals) {
  Geom<T> g;
  g.off = static_cast<const int*>(tabs[0]);
  g.nbr = static_cast<const int*>(tabs[1]);
  g.sw = static_cast<const T*>(tabs[2]);
  g.path = static_cast<const T*>(tabs[3]);
  g.diag = static_cast<const T*>(tabs[4]);
  g.geom = static_cast<const T*>(tabs[5]);
  g.rated = static_cast<const uint8_t*>(tabs[6]);
  g.shell = static_cast<const int*>(tabs[7]);
  g.inv = static_cast<const int*>(tabs[8]);
  for (int k = 0; k < 4; ++k) g.tab[k] = static_cast<const T*>(tabs[9 + k]);
  g.C = dims[0];
  g.n_shells = dims[1];
  g.N = dims[2];
  g.max_q = dims[3];
  g.lo = dims[4];
  g.side = dims[5];
  g.num_tau = dims[6];
  g.grey = dims[7] != 0;
  g.dr = static_cast<T>(vals[0]);
  g.sig = static_cast<T>(vals[1]);
  g.minlogtau = static_cast<T>(vals[2]);
  g.inv_dlogtau = static_cast<T>(1.0 / vals[3]);
  return g;
}

// The periodic image of p + d, p in [0, N), |d| < N.
__device__ __forceinline__ int wrap_add(int p, int d, int N) {
  const int v = p + d;
  return v < 0 ? v + N : (v >= N ? v - N : v);
}

// The grid coordinates of cell i of the source at p (in [0, N)^3).
template <typename T>
__device__ __forceinline__ void grid_xyz(const Geom<T>& g, const int* p,
                                         int i, int xyz[3]) {
  for (int k = 0; k < 3; ++k)
    xyz[k] = wrap_add(p[k], g.off[size_t(k) * g.C + i], g.N);
}

__device__ __forceinline__ long long flat_index(const int xyz[3], int N) {
  return (static_cast<long long>(xyz[0]) * N + xyz[1]) * N + xyz[2];
}

// ---------------------------------------------------------------------------
// the sweep
// ---------------------------------------------------------------------------

// What a cell's step needs beside its corners' column densities.
template <typename T>
struct Operands {
  int n[4];
  T s[4];
  T pdr, diag, nhi;
};

template <typename T>
__device__ __forceinline__ void load_operands(const Geom<T>& g, const T* nhi,
                                              const int* p, int i,
                                              Operands<T>& o) {
  for (int k = 0; k < 4; ++k) {
    o.n[k] = g.nbr[size_t(k) * g.C + i];
    o.s[k] = g.sw[size_t(k) * g.C + i];
  }
  o.pdr = mul(g.path[i], g.dr);
  o.diag = g.diag[i];
  int xyz[3];
  grid_xyz(g, p, i, xyz);
  o.nhi = nhi[flat_index(xyz, g.N)];
}

// The outgoing column density of a cell of the shell that starts at cell
// `start`: cdin = diag sum(c w) / sum(w), w = sw / max(c sig, 0.6), plus
// nHI path dr.
template <typename T>
__device__ __forceinline__ T outgoing(const Operands<T>& o, const T* cd,
                                      int start, T sig) {
  const T lim = static_cast<T>(0.6);
  T num = T(0), den = T(0);
  for (int k = 0; k < 4; ++k) {
    const T c = o.n[k] < start ? __ldcg(cd + o.n[k]) : T(0);
    const T w = div(o.s[k], clamp_min(mul(c, sig), lim));
    num = add(num, mul(c, w));
    den = add(den, w);
  }
  return add(div(mul(o.diag, num), den), mul(o.nhi, o.pdr));
}

// Cluster s = blockIdx.x / cluster sweeps source s of the batch (at pos[s],
// in [0, N)^3) into row s of cd (B, C). Every thread of the cluster passes
// the same n_shells + 1 barriers.
template <typename T>
__global__ void __launch_bounds__(kSweepThreads, 1)
flat_sweep_kernel(Geom<T> g, const T* nhi, const int* pos, T* cd_all,
                  int cluster) {
  const int src = blockIdx.x / cluster;
  const int t = (blockIdx.x % cluster) * blockDim.x + threadIdx.x;
  const int stride = cluster * blockDim.x;
  int p[3];
  for (int k = 0; k < 3; ++k) p[k] = pos[3 * src + k];
  T* cd = cd_all + size_t(src) * g.C;
  if (t == 0) {
    // the source cell: coldensh_in = 0 over half a cell (path[0] = 0.5)
    int xyz[3];
    grid_xyz(g, p, 0, xyz);
    __stcg(cd, mul(nhi[flat_index(xyz, g.N)], mul(g.path[0], g.dr)));
  }
  cheb::cluster_arrive();
  for (int q = 1; q <= g.n_shells; ++q) {
    const int start = g.shell[q], end = g.shell[q + 1];
    int i = start + t;
    Operands<T> o;
    if (i < end) load_operands(g, nhi, p, i, o);
    cheb::cluster_wait();        // shell q - 1 is written
    while (i < end) {
      __stcg(cd + i, outgoing(o, cd, start, g.sig));
      i += stride;
      if (i < end) load_operands(g, nhi, p, i, o);
    }
    cheb::cluster_arrive();
  }
  cheb::cluster_wait();
}

// ---------------------------------------------------------------------------
// the rate pass
// ---------------------------------------------------------------------------

// Log-linear table interpolation in log10(tau) (rates.cu:70-83).
template <typename T>
__device__ __forceinline__ T lookup(const Geom<T>& g, const T* table, T tau) {
  const T logtau = log10_(clamp_min(tau, static_cast<T>(1.0e-20)));
  const T real_i =
      clamp(add(mul(sub(logtau, g.minlogtau), g.inv_dlogtau), T(1)), T(0),
            static_cast<T>(g.num_tau));
  const long long i0 = static_cast<long long>(real_i);
  const T resid = sub(real_i, static_cast<T>(i0));
  const long long i1 = i0 + 1 < g.num_tau ? i0 + 1 : g.num_tau;
  const T t0 = table[i0];
  return add(t0, mul(resid, sub(table[i1], t0)));
}

// The pointers of one batch's rate pass.
template <typename T>
struct RateIO {
  const T* nhi;           // (N^3,) the HI density grid
  const int* pos;         // (B, 3) in [0, N)
  const T* flux;          // (B,) / S*
  const T* sdr3;          // S* / dr^3, on the device
  const T* cd;            // (B, C) outgoing column densities
  T* phi;                 // (B, C) out
  T* heat;                // (B, C) out, null without the heat channel
};

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y: cell i of source b.
template <typename T, bool GREY, bool HEAT>
__global__ void __launch_bounds__(kThreads)
flat_rates_kernel(Geom<T> g, RateIO<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (i >= g.C) return;
  int xyz[3];
  grid_xyz(g, a.pos + 3 * b, i, xyz);
  const size_t k = size_t(b) * g.C + i;
  const T nhi = a.nhi[flat_index(xyz, g.N)];
  const T cdo = a.cd[k];
  const T dcol = mul(nhi, mul(g.path[i], g.dr));
  const T cdin = sub(cdo, dcol);
  const T tau_in = mul(cdin, g.sig), tau_out = mul(cdo, g.sig);
  const T dtau = mul(dcol, g.sig);
  const T prefact = mul(mul(a.flux[b], *a.sdr3), g.geom[i]);
  const bool thick = dtau > static_cast<T>(kTauPhotoLimit);
  T phi, heat = T(0);
  if (GREY) {
    const T ein = exp_(-tau_in);
    phi = thick ? mul(prefact, sub(ein, exp_(-tau_out)))
                : mul(mul(prefact, dtau), ein);
  } else {
    phi = thick ? mul(prefact, sub(lookup(g, g.tab[1], tau_in),
                                   lookup(g, g.tab[1], tau_out)))
                : mul(mul(prefact, dtau), lookup(g, g.tab[0], tau_in));
    if (HEAT)
      heat = thick ? mul(prefact, sub(lookup(g, g.tab[3], tau_in),
                                      lookup(g, g.tab[3], tau_out)))
                   : mul(mul(prefact, dtau), lookup(g, g.tab[2], tau_in));
  }
  // LLS / max-column-density cutoffs; a zero-density cell's rate per atom
  // is 0 (the smallest normal float as its density)
  const bool mask = cdin <= static_cast<T>(kMaxColdensH) && g.rated[i];
  const T nhi_safe = clamp_min(nhi, tiny<T>());
  a.phi[k] = mask ? div(phi, nhi_safe) : T(0);
  if (HEAT) a.heat[k] = mask ? div(heat, nhi_safe) : T(0);
}

// ---------------------------------------------------------------------------
// the accumulate
// ---------------------------------------------------------------------------

// The cell of the octahedron of the source at p that lies on grid cell xyz,
// or -1 (the offset taken into the periodic image [-(N/2), N/2 - 1 + N%2]
// of each axis, as the tables clip it); with `covers_only` 0 or -1 without
// the table's load.
template <typename T>
__device__ __forceinline__ int cell_at(const Geom<T>& g, const int* p,
                                       const int xyz[3], bool covers_only) {
  const int last_l = -(g.N / 2), last_r = g.N / 2 - 1 + g.N % 2;
  int d[3], l1 = 0;
  for (int k = 0; k < 3; ++k) {
    int v = xyz[k] - p[k];
    v = v > last_r ? v - g.N : (v < last_l ? v + g.N : v);
    d[k] = v;
    l1 += v < 0 ? -v : v;
  }
  if (l1 > g.max_q) return -1;
  if (covers_only) return 0;
  return g.inv[(size_t(d[0] - g.lo) * g.side + (d[1] - g.lo)) * g.side +
               (d[2] - g.lo)];
}

// The pointers of one batch's accumulate.
template <typename T>
struct AccIO {
  const int* pos;         // (B, 3) in [0, N)
  const T* phi;           // (B, C)
  const T* heat;          // (B, C), null without the heat channel
  T* phi_grid;            // (N^3,)
  T* heat_grid;           // (N^3,), null without the heat channel
  int B;
};

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y: cell i of source b,
// the owner of its grid cell where no lower source covers it.
template <typename T, bool HEAT>
__global__ void __launch_bounds__(kThreads)
flat_accumulate_kernel(Geom<T> g, AccIO<T> a) {
  const int* ps = a.pos;        // (B, 3)
  const int i = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (i >= g.C) return;
  int xyz[3];
  grid_xyz(g, ps + 3 * b, i, xyz);
  for (int b2 = 0; b2 < b; ++b2)
    if (cell_at(g, ps + 3 * b2, xyz, true) >= 0) return;   // not the owner
  const long long cell = flat_index(xyz, g.N);
  atomicAdd(a.phi_grid + cell, a.phi[size_t(b) * g.C + i]);
  if (HEAT) atomicAdd(a.heat_grid + cell, a.heat[size_t(b) * g.C + i]);
  for (int b2 = b + 1; b2 < a.B; ++b2) {
    const int j = cell_at(g, ps + 3 * b2, xyz, false);
    if (j < 0) continue;
    atomicAdd(a.phi_grid + cell, a.phi[size_t(b2) * g.C + j]);
    if (HEAT) atomicAdd(a.heat_grid + cell, a.heat[size_t(b2) * g.C + j]);
  }
}

// ---------------------------------------------------------------------------
// the trace
// ---------------------------------------------------------------------------

// The pointers of a trace of nb batches of B sources.
template <typename T>
struct Trace {
  const T* nhi;             // (N^3,) the HI density grid
  const int* pos;           // (nb, B, 3) in [0, N)
  const T* flux;            // (nb, B) / S*
  const T* sdr3;            // S* / dr^3, on the device
  T* cd;                    // (B, C) scratch: the sweep's column densities
  T* phi;                   // (B, C) scratch: the rates
  T* heat;                  // (B, C) scratch, null without the heat channel
  T* phi_grid;              // (N^3,) accumulated into
  T* heat_grid;             // (N^3,), null without the heat channel
  int B;
  const int* pos_of(int b) const { return pos + size_t(3) * B * b; }
  RateIO<T> rates(int b) const {
    return RateIO<T>{nhi, pos_of(b), flux + size_t(B) * b, sdr3, cd, phi,
                     heat};
  }
  AccIO<T> acc(int b) const {
    return AccIO<T>{pos_of(b), phi, heat, phi_grid, heat_grid, B};
  }
};

// The launches of the flat kernels

template <typename T>
bool fits(const Geom<T>& g, int B, bool heat) {
  return g.C >= 1 && g.n_shells >= 0 && g.N >= 1 && B >= 1 &&
         B <= kMaxBatch && !(g.grey && heat) &&
         (g.grey || (g.tab[0] && g.tab[1])) &&
         (!heat || (g.tab[2] && g.tab[3]));
}

// B clusters of `cluster` blocks of kSweepThreads threads (or, with
// max_clusters, only ask how many of them the card holds at once).
template <typename T>
int launch_sweep(const Geom<T>& g, const T* nhi, const int* pos, T* cd,
                 int B, int cluster, int* max_clusters, cudaStream_t st) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 &&
      cluster != 16)
    return cudaErrorInvalidValue;
  const cheb::LaunchSpec spec{B, kSweepThreads, cluster, 0, 0, 0, 0,
                              max_clusters, st};
  return cheb::launch_cluster(flat_sweep_kernel<T>, spec, g, nhi, pos, cd,
                              cluster);
}

template <typename T>
int launch_rates(const Geom<T>& g, const RateIO<T>& a, int B,
                 cudaStream_t st) {
  const dim3 grid((g.C + kThreads - 1) / kThreads, B);
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
  if (a.heat)
    flat_accumulate_kernel<T, true><<<grid, kThreads, 0, st>>>(g, a);
  else
    flat_accumulate_kernel<T, false><<<grid, kThreads, 0, st>>>(g, a);
  return static_cast<int>(cudaGetLastError());
}

// The trace of nb batches: per batch the sweep, the rate pass and the
// accumulate, on `st`. Returns the first error; a refused launch never
// runs.
template <typename T>
int trace(const Geom<T>& g, const Trace<T>& tr, int nb, int cluster,
          cudaStream_t st) {
  for (int b = 0; b < nb; ++b) {
    int rc = launch_sweep<T>(g, tr.nhi, tr.pos_of(b), tr.cd, tr.B, cluster,
                             nullptr, st);
    if (rc == 0) rc = launch_rates<T>(g, tr.rates(b), tr.B, st);
    if (rc == 0) rc = launch_accumulate<T>(g, tr.acc(b), st);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace flat

extern "C" {

// The entry points take the engine's tables as `tabs` (13 pointers), `dims`
// (8 ints) and `vals` (4 doubles) in make_geom's order, and
// return the first cudaError_t that is not cudaSuccess (an invalid size
// is cudaErrorInvalidValue, nothing launched).
//
// flat_sweep: the sweep of the B sources at pos (B, 3), int32 in [0, N)
// (ops/flat_sweep.py::stage_positions), over the grid
// nhi (N^3) into cd (B, C), as B clusters of `cluster` blocks of
// kSweepThreads threads; with max_clusters set, launches nothing and writes
// there how many of those clusters are resident at once.
// flat_rates: the rate pass of those sources from cd, with the fluxes flux
// (B,) and S* / dr^3 at sdr3 (on the device), into phi (and heat, where it
// is set) (B, C).
// flat_accumulate: adds phi (and heat) of those sources into phi_grid (and
// heat_grid), source after source.
// flat_trace_sweep: the trace of nb batches (pos (nb, B, 3), flux (nb, B)):
// per batch the three above, with cd, phi and heat as scratch.
#define FLAT_ENTRIES(SFX, TYPE)                                                \
  int flat_sweep_##SFX(void* const* tabs, const int* dims,                     \
                       const double* vals, const void* nhi,                    \
                       const int* pos, void* cd, int B, int cluster,           \
                       int* max_clusters, void* stream) {                      \
    const flat::Geom<TYPE> g = flat::make_geom<TYPE>(tabs, dims, vals);        \
    if (!flat::fits(g, B, false)) return cudaErrorInvalidValue;                \
    return flat::launch_sweep<TYPE>(g, static_cast<const TYPE*>(nhi), pos,     \
                                    static_cast<TYPE*>(cd), B, cluster,        \
                                    max_clusters,                              \
                                    static_cast<cudaStream_t>(stream));        \
  }                                                                            \
  int flat_rates_##SFX(void* const* tabs, const int* dims,                     \
                       const double* vals, const void* nhi,                    \
                       const int* pos, const void* flux,                       \
                       const void* sdr3, const void* cd, void* phi,            \
                       void* heat, int B, void* stream) {                      \
    const flat::Geom<TYPE> g = flat::make_geom<TYPE>(tabs, dims, vals);        \
    if (!flat::fits(g, B, heat != nullptr)) return cudaErrorInvalidValue;      \
    using P = const TYPE*;                                                     \
    const flat::RateIO<TYPE> a{static_cast<P>(nhi), pos,                       \
                               static_cast<P>(flux), static_cast<P>(sdr3),     \
                               static_cast<P>(cd), static_cast<TYPE*>(phi),    \
                               static_cast<TYPE*>(heat)};                      \
    return flat::launch_rates<TYPE>(g, a, B,                                   \
                                    static_cast<cudaStream_t>(stream));        \
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
      const void* sdr3, void* cd, void* phi, void* heat, void* phi_grid,       \
      void* heat_grid, int nb, int B, int cluster, void* stream) {             \
    const flat::Geom<TYPE> g = flat::make_geom<TYPE>(tabs, dims, vals);        \
    if (!flat::fits(g, B, heat != nullptr) || nb < 0 ||                        \
        (heat == nullptr) != (heat_grid == nullptr))                           \
      return cudaErrorInvalidValue;                                            \
    using P = const TYPE*;                                                     \
    const flat::Trace<TYPE> tr{static_cast<P>(nhi), pos,                       \
                               static_cast<P>(flux), static_cast<P>(sdr3),     \
                               static_cast<TYPE*>(cd),                         \
                               static_cast<TYPE*>(phi),                        \
                               static_cast<TYPE*>(heat),                       \
                               static_cast<TYPE*>(phi_grid),                   \
                               static_cast<TYPE*>(heat_grid), B};              \
    return flat::trace<TYPE>(g, tr, nb, cluster,                               \
                             static_cast<cudaStream_t>(stream));               \
  }

FLAT_ENTRIES(f32, float)
FLAT_ENTRIES(f64, double)

const char* flat_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
