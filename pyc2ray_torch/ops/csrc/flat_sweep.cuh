// The flat engine's kernels on NVIDIA Hopper (sm_90a), device code: the
// octahedral gather of nHI, the shell sweep, the rate pass and the ordered
// accumulate of ops/raytrace.py's Raytracer. flat_sweep.cu launches them
// and issues a whole trace from the host side of its library;
// flat_probe.cu, which only chip_smoke.py builds, holds the forms that were
// measured and left out.
//
// Counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
// raytrace.py::Raytracer._trace_jit: the gather nhi_flat[lin] (:299), the
// lax.fori_loop over each shell bucket of _sweep (:172-209), the dense
// _rates (:224-283) and the lax.scan over batches with its scatter-add
// (:288-313)), which XLA runs on the device as one program. No TPU kernel
// of its own: the JAX engine's sweep is XLA code. Plain versions:
// ops/raytrace.py::Raytracer._gather, _sweep, _rates and _accumulate.
//
//   flat_gather_kernel      per source, nHI of every cell of its octahedron
//                           (ops/geometry.py's flat layout), staged through
//                           shared memory: reads and writes contiguous.
//   flat_sweep_kernel       per source, the outgoing HI column density of
//                           every cell of the octahedron, shell after shell.
//   flat_rates_kernel       per rated cell and source, the
//                           photoionization (and heating) rate per HI atom:
//                           the log-linear tables or the grey analytic
//                           form, and the MAX_COLDENSH mask.
//   flat_accumulate_kernel  adds a batch's B rate octahedra into the flat
//                           grid(s), source after source in batch order.
//
// The gather. The octahedral layout sorts the cells by shell q and, inside
// a shell, lexicographically by their offset (d0, d1, d2). So the cells of
// shell q with a given d0 and d1 in a band [d1a, d1a + nd1) are one
// contiguous run of the layout. A block takes one source and one such slab
// and band (kernel_tables' gather blocks: d0, d1a, nd1, the rows' first d2
// and their pitch, its runs): it reads the band's rows of the grid along z
// (contiguous but for at most one periodic wrap a row; only the cells of
// the octahedron) into shared memory, a warp a row and kGatherAhead loads
// a lane in flight, beside its runs and the places of its cells (gsoff,
// one 16-bit place a cell, in the runs' order); then each warp writes whole
// runs, one shell's run after another, reading the values back from shared
// memory.
// Every cell of the octahedron lies in exactly one run.
//
// The sweep's design for this card. Shell q's cells read the outgoing
// column densities of the last shells (every corner of nonzero weight lies
// 1 to depth - 1 shells back: ops/raytrace.py::kernel_tables computes the
// depth and asserts it), so the shells of a source form a chain of n_shells
// steps. One thread-block cluster of C blocks of 1024 threads works on one
// source (as K1, csrc/cheb_sweep.cuh); between two shells stands one
// cluster barrier, whose arrive releases the shell's values and whose wait
// acquires them. What stays on the chain is the corners' loads, five
// float64 divisions and the store:
//   - The column densities of the last `depth` shells live in a ring in
//     the cluster's distributed shared memory (the shared placement). A
//     shell is cut into kChunks chunks of u = ceil(n / kChunks) cells; block
//     r holds chunks [r kChunks / C, (r + 1) kChunks / C), a contiguous
//     slice of the shell, in slot q mod depth of its ring, and computes
//     those cells itself. A corner is read through map_shared_rank from the
//     block that holds it, at the address its code gives (kernel_tables'
//     corner codes: the corner's lag, chunk and place in the chunk, so the
//     codes hold for every cluster size). Every value is also stored to the
//     (B, C) output the rate pass reads. Where the ring does not fit a
//     block's shared memory, the column densities stay in global memory,
//     read and written past L1 (the global placement, chosen by
//     ops/flat_sweep.py::flat_plan, the cells dealt round robin over the
//     cluster's threads).
//   - nHI is gathered into the octahedral layout before the sweep, as the
//     JAX engine does, by the gather kernel; the chain then reads it
//     contiguously from L2. The operands of a thread's first cell of shell
//     q + 1 are loaded between shell q's arrive and its wait.
//
// Corners. The plain sweep gathers a shell's corners before it writes the
// shell, from a buffer of zeros: a corner of zero weight reads a finite
// c >= 0 there (a cell of an earlier shell) or 0 (of its own shell or a
// later one), and either way adds c 0 = +0 to both sums. Here a corner of
// zero weight reads 0 without a load, so for finite column densities the
// sums have the plain version's bits. The corner sums add
// ((0 + p0 + p1) + p2) + p3: ATen's reduction over a dimension of 4 that is
// not the innermost (one thread per output, its accumulators combined in
// order) and the CPU's. Only a shell of one cell, the far corner of an even
// mesh's whole box, makes the corners the innermost dimension, where ATen's
// CUDA reduction pairs them; that cell has a single corner of nonzero
// weight (checked for every even N up to 4096), so any order gives its
// bits.
//
// The rate pass. Threads run over the engine's list of rated cells
// (kernel_tables' rated_cells: dist2 <= R_max_LLS^2); the caller zeroes the
// outputs once, so an unrated cell holds the +0 that the plain version's
// mask stores there. A thread takes one cell of one source (several
// sources a thread were measured and left out: chip_smoke.py 3d's design
// steps). Each tau's log10,
// index and residual are formed once and every table that needs them reads
// them (photo thin and thick, heat thin and thick): the same operations on
// the same operands as the plain version's lookups, so the same bits.
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
// The accumulate. The plain version adds each source's rates with
// index_add_, source after source; within one source every grid cell occurs
// once (one periodic image), and index_add_ adds on the card with
// atomicAdd. Octahedra of one batch overlap, so here every grid cell a
// batch covers has one owner: the thread of the lowest source that covers
// it, which finds the covering sources by the offset of the cell from each
// (an inverse table of the clip cube gives the cell's index in a source's
// octahedron). The owner reads the grid cell once, adds the rates of the
// covering sources in ascending source order in a register with the
// instruction atomicAdd performs (float32: add.rn.ftz, which rounds to
// nearest and flushes subnormal inputs and results to zero, as atom.add.f32
// does; float64: add.rn), and stores once: no atomics. Thread k of a source
// takes its cell grid_order[k], so a warp walks runs of the grid along z.
//
// Bound. The sweep's chain is n_shells cluster barriers (52 at the bench
// configuration, 193 at the golden's whole-box octahedron at N = 128); a
// cell reads its 4 corners, its 4 weights, path, diag and its nHI and
// writes one value, and does 5 divisions and about 20 other operations.
// The gather reads the covered cells of the grid and writes B x C values.
// The rate pass reads the column density and the gathered nHI of a rated
// cell and writes one or two values; the tables' log10 (one a thin cell,
// two a thick one) are its most costly operations. The accumulate reads
// the batch's rates and reads and writes the covered cells of the grid.
// All move bytes more than they compute; chip_smoke.py's flat_work counts
// them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cheb_sweep.cuh"

namespace flat {

#include "rounded.cuh"

constexpr int kThreads = 256;        // threads per block of the gather,
                                     // the rate pass and the accumulate
constexpr int kSweepThreads = 1024;  // threads per block of the sweep
constexpr int kMaxBatch = 4096;      // most sources a batch
constexpr int kChunks = 16;          // chunks of a shell (the largest
                                     // cluster): block r of a cluster of C
                                     // holds kChunks / C of them
constexpr int kGroup = 4;            // higher sources the accumulate looks
                                     // up together
constexpr int kGatherAhead = 4;      // values a lane of the gather loads
                                     // at a time
constexpr int kGatherBlocks = 6;     // gather blocks an SM holds at least
                                     // (40 registers a thread)
constexpr int kBlockInts = 10;       // ints of a gather block's entry
constexpr int kRunInts = 3;          // ints of a run's entry
constexpr double kTauPhotoLimit = 1.0e-7;   // constants.TAU_PHOTO_LIMIT
constexpr double kMaxColdensH = 2.0e30;     // constants.MAX_COLDENSH

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() {
  return 1.17549435e-38f;                   // torch.finfo(float32).tiny
}
template <> __device__ __forceinline__ double tiny<double>() {
  return 2.2250738585072014e-308;
}

// The add of atomicAdd (atom.add): float32 rounds to nearest and flushes
// subnormal inputs and results to zero, float64 rounds to nearest.
__device__ __forceinline__ float acc_add(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ double acc_add(double a, double b) {
  return __dadd_rn(a, b);
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
  const int* code;        // (4, C) the corners' codes: -1 for a corner of
                          // zero weight, else off | chunk << 16 | lag << 20
                          // (the corner is cell chunk u + off of shell
                          // q - lag, u that shell's chunk length)
  const int* order;       // (C,) the cells in grid order
  const int* order_off;   // (C,) their offsets, packed: d0 - lo |
                          // (d1 - lo) << 10 | (d2 - lo) << 20
  const int* gblk;        // (n_blk, kBlockInts) the gather's blocks: d0,
                          // d1a, nd1, d2lo, pitch, first run, runs, their
                          // first place in gsoff, their cells, 0
  const int* grun;        // (n_run, kRunInts) its runs: first cell, cells,
                          // the first of their places in gsoff
  const uint16_t* gsoff;  // (C,) each run's cells' places in the block's
                          // shared memory, (d1 - d1a) pitch + d2 - d2lo
  const int* rcell;       // (n_rated,) the rated cells, ascending
  int C, n_shells, N, max_q, lo, side, num_tau;
  bool grey;              // the grey analytic rates instead of the tables
  int depth;              // shells in the ring: the largest lag + 1
  int max_u;              // the largest chunk length of a shell
  int n_blk;              // blocks of the gather a source
  int g_cells;            // the most values a gather block stages
  int n_rated;            // rated cells
  T dr, sig, minlogtau, inv_dlogtau;
};

constexpr int kTabs = 20;   // pointers of make_geom's tabs
constexpr int kDims = 13;   // ints of its dims

// tabs: off, nbr, sw, path, diag, geom, rated, shell, inv, the four tables,
// code, order, order_off, gblk, grun, gsoff, rcell; dims: C, n_shells, N,
// max_q, lo, side, num_tau, grey, depth, max_u, n_blk, g_cells, n_rated;
// vals: dr, sig, minlogtau, dlogtau.
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
  g.code = static_cast<const int*>(tabs[13]);
  g.order = static_cast<const int*>(tabs[14]);
  g.order_off = static_cast<const int*>(tabs[15]);
  g.gblk = static_cast<const int*>(tabs[16]);
  g.grun = static_cast<const int*>(tabs[17]);
  g.gsoff = static_cast<const uint16_t*>(tabs[18]);
  g.rcell = static_cast<const int*>(tabs[19]);
  g.C = dims[0];
  g.n_shells = dims[1];
  g.N = dims[2];
  g.max_q = dims[3];
  g.lo = dims[4];
  g.side = dims[5];
  g.num_tau = dims[6];
  g.grey = dims[7] != 0;
  g.depth = dims[8];
  g.max_u = dims[9];
  g.n_blk = dims[10];
  g.g_cells = dims[11];
  g.n_rated = dims[12];
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

// The grid coordinates of the k-th cell in grid order of the source at p.
template <typename T>
__device__ __forceinline__ void grid_xyz_ordered(const Geom<T>& g,
                                                 const int* p, int k,
                                                 int xyz[3]) {
  const int o = g.order_off[k];
  for (int a = 0; a < 3; ++a)
    xyz[a] = wrap_add(p[a], ((o >> (10 * a)) & 1023) + g.lo, g.N);
}

// ---------------------------------------------------------------------------
// the gather
// ---------------------------------------------------------------------------

// The bytes of shared memory a gather block stages: g_cells values, the
// runs of a block (at most max_q + 1: one a shell) and the places of its
// cells (at most g_cells).
template <typename T>
__host__ __device__ inline size_t gather_smem(const Geom<T>& g) {
  return size_t(g.g_cells) * (sizeof(T) + sizeof(uint16_t)) +
         size_t(kRunInts) * sizeof(int) * (g.max_q + 1);
}

// Row r of a gather block of the source at p: the octahedron's cells of
// the row (d0, d1a + r) lie at d2 in [lo2, lo2 + len), the row of the grid
// at `row`.
template <typename T>
struct GatherRow {
  const T* nhi;
  const int* p;
  long long x;                 // the slab's plane of the grid
  int d1a, d2lo, d2hi, rad, N; // d2hi: the block's last d2
  const T* row;
  int lo2, len;
  __device__ __forceinline__ void start(int r) {
    const int d1 = d1a + r, h = rad - (d1 < 0 ? -d1 : d1);
    lo2 = max(d2lo, -h);
    len = min(d2hi, h) - lo2 + 1;
    row = nhi + (x * N + wrap_add(p[1], d1, N)) * N;
  }
};

// Block (blockIdx.x, blockIdx.y): gather block blockIdx.x of source b =
// blockIdx.y; out (B, C) = nHI at the cells' images. Needs gather_smem
// bytes of dynamic shared memory and whole warps. The block first copies
// its runs and its cells' places into shared memory and reads its rows of
// the grid there, a warp a row, AHEAD values a lane in flight at a time;
// then a warp a run writes the run's cells; at least MINB blocks an SM.
// (Other AHEAD and MINB: the probe's forms.)
template <typename T, int AHEAD = kGatherAhead, int MINB = kGatherBlocks>
__global__ void __launch_bounds__(kThreads, MINB)
flat_gather_kernel(Geom<T> g, const T* nhi, const int* pos, T* out) {
  const int* blk = g.gblk + size_t(kBlockInts) * blockIdx.x;
  const int d0 = blk[0], d1a = blk[1], nd1 = blk[2], d2lo = blk[3];
  const int pitch = blk[4], run0 = blk[5], nrun = blk[6];
  const int place0 = blk[7], cells = blk[8];
  const int* p = pos + 3 * blockIdx.y;
  const int rad = g.max_q - (d0 < 0 ? -d0 : d0);   // the slab's L1 radius
  const long long x = wrap_add(p[0], d0, g.N);
  const int nt = blockDim.x, t = threadIdx.x;
  T* s = cheb::shared_mem<T>();                     // the staged values
  int* runs = reinterpret_cast<int*>(s + g.g_cells);
  uint16_t* at = reinterpret_cast<uint16_t*>(runs + kRunInts * (g.max_q + 1));
  for (int k = t; k < kRunInts * nrun; k += nt)
    runs[k] = g.grun[size_t(kRunInts) * run0 + k];
  for (int k = t; k < cells; k += nt) at[k] = g.gsoff[place0 + k];
  // the band's rows, the cells of the octahedron only, along z: a warp a
  // row at a time, 32 of its values a segment; a lane loads AHEAD
  // segments' values before it stores them
  const int lane = t & 31, warps = nt >> 5;
  GatherRow<T> w{nhi, p, x, d1a, d2lo, d2lo + pitch - 1, rad, g.N};
  int r = t >> 5, seg = 0;
  if (r < nd1) w.start(r);
  while (r < nd1) {
    T v[AHEAD];
    int put[AHEAD];
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      put[j] = -1;
      if (r < nd1) {
        const int k = 32 * seg + lane;
        if (k < w.len) {
          v[j] = w.row[wrap_add(p[2], w.lo2 + k, g.N)];
          put[j] = r * pitch + w.lo2 + k - d2lo;
        }
        if (32 * ++seg >= w.len) {
          r += warps;
          seg = 0;
          if (r < nd1) w.start(r);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < AHEAD; ++j)
      if (put[j] >= 0) s[put[j]] = v[j];
  }
  __syncthreads();
  // a warp a run: its cells contiguous in the octahedral layout
  T* o = out + size_t(blockIdx.y) * g.C;
  for (int j = t >> 5; j < nrun; j += warps) {
    const int first = runs[kRunInts * j], len = runs[kRunInts * j + 1];
    const uint16_t* place = at + (runs[kRunInts * j + 2] - place0);
    for (int k = lane; k < len; k += 32) o[first + k] = s[place[k]];
  }
}

// ---------------------------------------------------------------------------
// the sweep
// ---------------------------------------------------------------------------

// The chunk length of shell q.
template <typename T>
__device__ __forceinline__ int chunk_len(const Geom<T>& g, int q) {
  return (g.shell[q + 1] - g.shell[q] + kChunks - 1) / kChunks;
}

// What a cell's step needs beside the column densities it reads after the
// wait: per corner k where it is (n[k] < 0: a corner of zero weight) and
// its weight s[k]; diag and the cell's own column nHI path dr, formed as
// the plain version forms them.
template <typename T>
struct Operands {
  int n[4];
  T s[4];
  T diag, dcol;
};

// One source's sweep by one cluster; RING: the column densities of the
// last shells in the cluster's distributed shared memory (else in global
// memory).
template <typename T, bool RING>
struct Sweep {
  Geom<T> g;
  const T* no;      // the source's gathered nHI (C,)
  T* cd;            // the source's column densities (C,)
  T* ring;          // this block's ring: depth slots of cap values
  int lgC, rank, cap, nt;

  // This thread's cells start + l of shell q, l in [first, end) by
  // `stride`: a contiguous slice of the shell a block, at `lo` (ring), or
  // round robin over the cluster's threads.
  __device__ __forceinline__ void cells(int q, int& start, int& first,
                                        int& end, int& stride,
                                        int& lo) const {
    start = g.shell[q];
    const int n = g.shell[q + 1] - start;
    if (RING) {
      const int per = kChunks >> lgC;
      const int u = (n + kChunks - 1) / kChunks;
      lo = rank * per * u;
      first = lo + threadIdx.x;
      end = min(lo + per * u, n);
      stride = nt;
    } else {
      lo = 0;
      first = rank * nt + threadIdx.x;
      end = n;
      stride = nt << lgC;
    }
  }

  // Where corner code c of a cell of shell q is: its cell (global
  // placement) or rank << 24 | its place in that rank's ring.
  __device__ __forceinline__ int where(int c, int q) const {
    if (c < 0) return -1;
    const int lag = c >> 20, chunk = (c >> 16) & 15, off = c & 0xffff;
    const int q2 = q - lag, u = chunk_len(g, q2);
    if (!RING) return g.shell[q2] + chunk * u + off;
    const int per_lg = 4 - lgC;              // log2 of chunks a block
    const int slot = q2 % g.depth;
    return (chunk >> per_lg) << 24 |
           (slot * cap + (chunk & ((1 << per_lg) - 1)) * u + off);
  }

  __device__ __forceinline__ T corner(int n) const {
    if (n < 0) return T(0);
    if (!RING) return __ldcg(cd + n);
    return *cooperative_groups::this_cluster().map_shared_rank(
        ring + (n & 0xffffff), unsigned(n) >> 24);
  }

  // The operands of cell i of shell q, loaded from the tables (every load
  // issued before the corners' places are worked out).
  __device__ __forceinline__ void load(int q, int i, Operands<T>& o) const {
    int c[4];
    for (int k = 0; k < 4; ++k) {
      c[k] = g.code[size_t(k) * g.C + i];
      o.s[k] = g.sw[size_t(k) * g.C + i];
    }
    const T v = __ldcg(no + i), path = g.path[i];
    o.diag = g.diag[i];
    for (int k = 0; k < 4; ++k) o.n[k] = where(c[k], q);
    o.dcol = mul(v, mul(path, g.dr));
  }

  // The outgoing column density of a cell: cdin = diag sum(c w) / sum(w),
  // w = sw / max(c sig, 0.6), plus nHI path dr.
  __device__ __forceinline__ T outgoing(const Operands<T>& o) const {
    T num = T(0), den = T(0);
    for (int k = 0; k < 4; ++k) {
      const T c = corner(o.n[k]);
      const T w = div(o.s[k], clamp_min(mul(c, g.sig), static_cast<T>(0.6)));
      num = add(num, mul(c, w));
      den = add(den, w);
    }
    return add(div(mul(o.diag, num), den), o.dcol);
  }

  // Cell i of the shell; `at` its place in this block's slot.
  __device__ __forceinline__ void put(int i, int at, T v) const {
    if (RING) {
      ring[at] = v;
      cd[i] = v;
    } else {
      __stcg(cd + i, v);
    }
  }
};

// Cluster s = blockIdx.x >> lgC sweeps source s of the batch (at pos[s],
// in [0, N)^3) into row s of cd (B, C), reading row s of nhi_octa (the
// gathered nHI). Every thread of the cluster passes the same barriers.
template <typename T, bool RING>
__global__ void __launch_bounds__(kSweepThreads, 1)
flat_sweep_kernel(Geom<T> g, const T* nhi, const int* pos,
                  const T* nhi_octa, T* cd_all, int lgC) {
  const int src = blockIdx.x >> lgC, rank = blockIdx.x & ((1 << lgC) - 1);
  const int nt = blockDim.x, t = threadIdx.x;
  const int per = kChunks >> lgC;           // chunks a block holds
  int p[3];
  for (int k = 0; k < 3; ++k) p[k] = pos[3 * src + k];
  const int cap = per * g.max_u;
  const Sweep<T, RING> S{g, nhi_octa + size_t(src) * g.C,
                         cd_all + size_t(src) * g.C,
                         RING ? cheb::shared_mem<T>() : nullptr, lgC, rank,
                         cap, nt};
  if (rank == 0 && t == 0) {
    // the source cell, shell 0 (slot 0): coldensh_in = 0 over half a cell
    // (path[0] = 0.5)
    int xyz[3];
    grid_xyz(g, p, 0, xyz);
    S.put(0, 0, mul(nhi[flat_index(xyz, g.N)], mul(g.path[0], g.dr)));
  }
  cheb::cluster_arrive();
  for (int q = 1; q <= g.n_shells; ++q) {
    int start, first, end, stride, lo;
    S.cells(q, start, first, end, stride, lo);
    const int slot = RING ? (q % g.depth) * cap : 0;
    Operands<T> o;
    if (first < end) S.load(q, start + first, o);
    cheb::cluster_wait();        // shells q - depth + 1 .. q - 1 are written
    if (first < end) S.put(start + first, slot + first - lo, S.outgoing(o));
    for (int l = first + stride; l < end; l += stride) {
      Operands<T> x;
      S.load(q, start + l, x);
      S.put(start + l, slot + l - lo, S.outgoing(x));
    }
    cheb::cluster_arrive();
  }
  cheb::cluster_wait();
}

// ---------------------------------------------------------------------------
// the rate pass
// ---------------------------------------------------------------------------

// Where tau lies in the log-linear tables (rates.cu:70-83): the two indices
// and the residual, as the plain version's lookup forms them.
template <typename T>
struct TauAt {
  long long i0, i1;
  T resid;
};

template <typename T>
__device__ __forceinline__ TauAt<T> tau_at(const Geom<T>& g, T tau) {
  const T logtau = log10_(clamp_min(tau, static_cast<T>(1.0e-20)));
  const T real_i =
      clamp(add(mul(sub(logtau, g.minlogtau), g.inv_dlogtau), T(1)), T(0),
            static_cast<T>(g.num_tau));
  TauAt<T> a;
  a.i0 = static_cast<long long>(real_i);
  a.resid = sub(real_i, static_cast<T>(a.i0));
  a.i1 = a.i0 + 1 < g.num_tau ? a.i0 + 1 : g.num_tau;
  return a;
}

// The table's value at a: t0 + resid (t1 - t0).
template <typename T>
__device__ __forceinline__ T interp(const T* table, const TauAt<T>& a) {
  const T t0 = table[a.i0];
  return add(t0, mul(a.resid, sub(table[a.i1], t0)));
}

// The log-linear table interpolation of one tau (rates.cu:70-83).
template <typename T>
__device__ __forceinline__ T lookup(const Geom<T>& g, const T* table, T tau) {
  return interp(table, tau_at(g, tau));
}

// The rates per HI atom of one cell of one source: (phi, heat) from its
// gathered nHI, its outgoing column density cdo, path dr (pdr) and the
// volume prefactor; 0 where cdin exceeds MAX_COLDENSH or the density is 0.
template <typename T, bool GREY, bool HEAT>
__device__ __forceinline__ void cell_rates(const Geom<T>& g, T nhi, T cdo,
                                           T pdr, T prefact, T& phi_out,
                                           T& heat_out) {
  const T dcol = mul(nhi, pdr);
  const T cdin = sub(cdo, dcol);
  const T tau_in = mul(cdin, g.sig), tau_out = mul(cdo, g.sig);
  const T dtau = mul(dcol, g.sig);
  const bool thick = dtau > static_cast<T>(kTauPhotoLimit);
  T phi, heat = T(0);
  if (GREY) {
    const T ein = exp_(-tau_in);
    phi = thick ? mul(prefact, sub(ein, exp_(-tau_out)))
                : mul(mul(prefact, dtau), ein);
  } else {
    const TauAt<T> in = tau_at(g, tau_in);
    if (thick) {
      const TauAt<T> out = tau_at(g, tau_out);
      phi = mul(prefact, sub(interp(g.tab[1], in), interp(g.tab[1], out)));
      if (HEAT)
        heat = mul(prefact, sub(interp(g.tab[3], in), interp(g.tab[3], out)));
    } else {
      const T pd = mul(prefact, dtau);
      phi = mul(pd, interp(g.tab[0], in));
      if (HEAT) heat = mul(pd, interp(g.tab[2], in));
    }
  }
  // the max-column-density cutoff; a zero-density cell's rate per atom is
  // 0 (the smallest normal float as its density)
  const bool mask = cdin <= static_cast<T>(kMaxColdensH);
  const T nhi_safe = clamp_min(nhi, tiny<T>());
  phi_out = mask ? div(phi, nhi_safe) : T(0);
  heat_out = mask ? div(heat, nhi_safe) : T(0);
}

// The pointers of one batch's rate pass.
template <typename T>
struct RateIO {
  const T* nhi_octa;      // (B, C) the gathered nHI
  const T* flux;          // (B,) / S*
  const T* sdr3;          // S* / dr^3, on the device
  const T* cd;            // (B, C) outgoing column densities
  T* phi;                 // (B, C) out, the rated cells only
  T* heat;                // (B, C) out, null without the heat channel
  int B;
};

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y: rated cell rcell[j]
// of source b = blockIdx.y.
template <typename T, bool GREY, bool HEAT>
__global__ void __launch_bounds__(kThreads)
flat_rates_kernel(Geom<T> g, RateIO<T> a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (j >= g.n_rated) return;
  const int i = g.rcell[j];
  const size_t k = size_t(b) * g.C + i;
  T phi, heat;
  cell_rates<T, GREY, HEAT>(g, a.nhi_octa[k], a.cd[k], mul(g.path[i], g.dr),
                            mul(mul(a.flux[b], *a.sdr3), g.geom[i]), phi,
                            heat);
  a.phi[k] = phi;
  if (HEAT) a.heat[k] = heat;
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

// Whether the octahedra of the sources at p and r may share a cell: the
// periodic L1 distance of p and r is at most 2 max_q (a cell of both lies
// within max_q of each, on each axis the least image of p - r is at most
// the distance through that cell).
template <typename T>
__device__ __forceinline__ bool may_meet(const Geom<T>& g, const int* p,
                                         const int* r) {
  int l1 = 0;
  for (int k = 0; k < 3; ++k) {
    const int d = p[k] < r[k] ? r[k] - p[k] : p[k] - r[k];
    l1 += d < g.N - d ? d : g.N - d;
  }
  return l1 <= 2 * g.max_q;
}

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y: cell order[k] of
// source b, the owner of its grid cell where no lower source covers it.
// Only the sources whose octahedra may meet source b's (may_meet) are
// looked at: the block's first thread lists them in ascending order in
// shared memory (B + 1 ints: the list, then its length) before the others
// start.
template <typename T, bool HEAT>
__global__ void __launch_bounds__(kThreads)
flat_accumulate_kernel(Geom<T> g, AccIO<T> a) {
  const int* ps = a.pos;        // (B, 3)
  const int k = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  int* near = cheb::shared_mem<int>();
  if (threadIdx.x == 0) {
    int count = 0;
    for (int b2 = 0; b2 < a.B; ++b2)
      if (b2 != b && may_meet(g, ps + 3 * b, ps + 3 * b2)) near[count++] = b2;
    near[a.B] = count;
  }
  __syncthreads();
  if (k >= g.C) return;
  const int n_near = near[a.B];
  int xyz[3];
  grid_xyz_ordered(g, ps + 3 * b, k, xyz);
  int m = 0;
  for (; m < n_near && near[m] < b; ++m)
    if (cell_at(g, ps + 3 * near[m], xyz, true) >= 0) return;  // not owner
  const int i = g.order[k];
  const long long cell = flat_index(xyz, g.N);
  T phi = acc_add(a.phi_grid[cell], a.phi[size_t(b) * g.C + i]);
  T heat = HEAT ? acc_add(a.heat_grid[cell], a.heat[size_t(b) * g.C + i])
                : T(0);
  // the higher sources kGroup at a time: their cells found, then their
  // rates loaded together, then added in source order
  for (; m < n_near; m += kGroup) {
    int j[kGroup], b2[kGroup];
    T v[kGroup], h[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      b2[u] = m + u < n_near ? near[m + u] : 0;
      j[u] = m + u < n_near ? cell_at(g, ps + 3 * b2[u], xyz, false) : -1;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (j[u] < 0) continue;
      v[u] = a.phi[size_t(b2[u]) * g.C + j[u]];
      if (HEAT) h[u] = a.heat[size_t(b2[u]) * g.C + j[u]];
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (j[u] < 0) continue;
      phi = acc_add(phi, v[u]);
      if (HEAT) heat = acc_add(heat, h[u]);
    }
  }
  a.phi_grid[cell] = phi;
  if (HEAT) a.heat_grid[cell] = heat;
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
  T* nhi_octa;              // (B, C) scratch: the gathered nHI
  T* cd;                    // (B, C) scratch: the sweep's column densities
  T* phi;                   // (B, C) scratch: the rates
  T* heat;                  // (B, C) scratch, null without the heat channel
  T* phi_grid;              // (N^3,) accumulated into
  T* heat_grid;             // (N^3,), null without the heat channel
  int B;
  const int* pos_of(int b) const { return pos + size_t(3) * B * b; }
  RateIO<T> rates(int b) const {
    return RateIO<T>{nhi_octa, flux + size_t(B) * b, sdr3, cd, phi, heat, B};
  }
  AccIO<T> acc(int b) const {
    return AccIO<T>{pos_of(b), phi, heat, phi_grid, heat_grid, B};
  }
};

// Whether a launch of B sources fits the tables (the heat channel's
// tables present where `heat`).
template <typename T>
bool fits(const Geom<T>& g, int B, bool heat) {
  return g.C >= 1 && g.n_shells >= 0 && g.N >= 1 && B >= 1 &&
         B <= kMaxBatch && g.depth >= 2 && g.max_u >= 1 && g.n_blk >= 1 &&
         g.g_cells >= 1 && g.n_rated >= 1 && !(g.grey && heat) &&
         (g.grey || (g.tab[0] && g.tab[1])) &&
         (!heat || (g.tab[2] && g.tab[3]));
}

// Bytes of a block's ring in a cluster of `cluster` blocks.
template <typename T>
int ring_bytes(const Geom<T>& g, int cluster) {
  return int(size_t(g.depth) * (kChunks / cluster) * g.max_u * sizeof(T));
}

}  // namespace flat
