// The flat engine's trace on NVIDIA Hopper (sm_90a): the octahedral gather
// of nHI, the shell sweep, the rate pass and the ordered accumulate of
// ops/raytrace.py's Raytracer, and the loop that issues a whole trace from
// the host side of the library.
//
// Counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
// raytrace.py::Raytracer._trace_jit: the gather nhi_flat[lin] (:299), the
// lax.fori_loop over each shell bucket of _sweep (:172-209), the dense
// _rates (:224-283) and the lax.scan over batches with its scatter-add
// (:288-313)), which XLA runs on the device as one program. No TPU kernel
// of its own: the JAX engine's sweep is XLA code. Plain versions:
// ops/raytrace.py::Raytracer._gather, _sweep, _rates and _accumulate; of
// the loop, ops/flat_sweep.py::flat_trace_sweep_ref.
//
//   flat_gather_kernel      per source, nHI of every cell of its octahedron
//                           (ops/geometry.py's flat layout), read from the
//                           grid in grid order.
//   flat_sweep_kernel       per source, the outgoing HI column density of
//                           every cell of the octahedron, shell after shell.
//   flat_rates_kernel       per (source, cell) the photoionization (and
//                           heating) rate per HI atom: the log-linear
//                           tables or the grey analytic form, and the
//                           MAX_COLDENSH and R_max_LLS masks.
//   flat_accumulate_kernel  adds a batch's B rate octahedra into the flat
//                           grid(s), source after source in batch order.
//   trace                   per device batch (`chunk` consecutive batches)
//                           gather -> sweep -> rates -> accumulate on one
//                           stream, nothing synchronizing with the host.
//
// The sweep's design for this card. Shell q's cells read the outgoing
// column densities of the last shells (every corner of nonzero weight lies
// 1 to depth - 1 shells back: ops/raytrace.py::kernel_tables computes the
// depth and asserts it), so the shells of a source form a chain of n_shells
// steps. One thread-block cluster of C blocks of 1024 threads works on one
// source (as K1, csrc/cheb_sweep.cuh); between two shells stands one
// cluster barrier, whose arrive releases the shell's values and whose wait
// acquires them. What stays on the chain is the corners' loads, five
// float64 divisions and the store; measured on the card (chip_smoke.py 3d,
// the design steps), the divisions and the barrier set its pace, so the
// design takes the loads off the chain and fills the card:
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
//     JAX engine does, by a launch of its own over the whole card in grid
//     order (kernel_tables' grid_order: the cells of the octahedron in
//     lexicographic order of their offsets, so neighbouring threads read
//     neighbouring cells of the grid along z); the chain then reads it
//     contiguously from L2. The operands of a thread's first cell of shell
//     q + 1 are loaded between shell q's arrive and its wait.
//   - The loop sweeps `chunk` consecutive batches at once where the card
//     holds their clusters (flat_plan), so the SMs a batch of B clusters
//     leaves idle sweep the next batch.
// The launch code makes blocks of 1024 threads at one block per SM; the
// caller picks C and the placement (flat_plan): the largest cluster of
// which all B fit on the card at once. Forms that were measured and left
// out (nHI gathered in the chain or by the sweep's own prologue, two cells'
// operands ahead, the corners of lag >= 2 and their terms formed before the
// wait, a block's own corners read from its own shared memory, a cp.async
// stage two shells ahead) and the bare barriers are launched only by the
// probe entry point, for the table of the design steps.
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
// The rate pass reads the column density, the grid's nHI and four values of
// the tables a cell and writes one or two values; the tables' log10 (two or
// three a cell, six with the heat channel) are its most costly operations.
// The accumulate reads the batch's rates and reads and writes the covered
// cells of the grid. All move bytes more than they compute; chip_smoke.py's
// flat_work counts them.

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
constexpr int kAheadCells = 2;       // cells a thread loads ahead of a wait
constexpr int kGatherCells = 8;      // cells a thread of the sweep's
                                     // prologue gathers at a time
constexpr int kGroup = 4;            // higher sources the accumulate looks
                                     // up together
constexpr double kTauPhotoLimit = 1.0e-7;   // constants.TAU_PHOTO_LIMIT
constexpr double kMaxColdensH = 2.0e30;     // constants.MAX_COLDENSH

// Forms of the sweep kernel (bits). The engine runs kShared and kGlobal;
// the probe entry point runs any of them.
constexpr int kBare = 1;       // the cluster barriers alone
constexpr int kPre = 2;        // nHI pre-gathered (else read from the grid
                               // in the chain, at each cell's image)
constexpr int kRing = 4;       // column densities in the shared ring (else
                               // in global memory)
constexpr int kAhead = 8;      // kAheadCells cells loaded ahead (else one)
constexpr int kCodes = 16;     // corners by their codes (else by their
                               // cells, loaded where they lie in an
                               // earlier shell); implied by kRing
constexpr int kPrologue = 32;  // with kPre: the sweep gathers nHI itself
                               // before its first shell (else the gather
                               // kernel does, launched before it)
constexpr int kNoOut = 64;     // probe only: the ring form writes no output
constexpr int kNoDiv = 128;    // probe only: a multiply for each division
constexpr int kNoCorner = 256; // probe only: every corner reads 0
constexpr int kNoLoad = 512;   // probe only: no operand loads (constants)
constexpr int kEarly = 1024;   // with the codes: a corner lag >= 2 shells
                               // back, and its term, read and formed
                               // before the wait (its shell is published)
constexpr int kLocal = 2048;   // ring: a corner of this block read from its
                               // own shared memory, not through the cluster
constexpr int kStage = 4096;   // a thread's first cell of shell q + 2 copied
                               // into shared memory (cp.async) while shell q
                               // runs, in place of its loads ahead
constexpr int kShared = kPre | kRing | kCodes;
constexpr int kGlobal = kPre | kCodes;

// The probe's forms, in the order of chip_smoke.py's table of the design
// steps: the first port's chain, the bare barriers, nHI pre-gathered by the
// gather kernel or by the sweep's prologue, the ring, the ring with the
// prologue, the engine's two forms, the shared form with each step that was
// measured and left out (two cells ahead, the early corners, the local
// reads, the cp.async stage), and with parts of its shell step taken out.
#define FLAT_PROBE_FORMS(X)                                                    \
  X(0) X(kBare) X(kPre) X(kPre | kPrologue) X(kRing)                          \
  X(kRing | kPre | kPrologue) X(kShared) X(kGlobal) X(kShared | kAhead)       \
  X(kShared | kEarly) X(kShared | kLocal) X(kShared | kStage)                \
  X(kShared | kNoDiv) X(kShared | kNoCorner) X(kShared | kNoLoad)            \
  X(kShared | kNoLoad | kNoDiv) X(kShared | kNoLoad | kNoDiv | kNoOut)

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

// An asynchronous copy of B (4 or 8) bytes from global memory to this
// thread's shared memory (cp.async), the closing of a group of them and the
// wait until all but the last group have landed.
template <int B>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(B) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
  int C, n_shells, N, max_q, lo, side, num_tau;
  bool grey;              // the grey analytic rates instead of the tables
  int depth;              // shells in the ring: the largest lag + 1
  int max_u;              // the largest chunk length of a shell
  T dr, sig, minlogtau, inv_dlogtau;
};

// tabs: off, nbr, sw, path, diag, geom, rated, shell, inv, the four tables,
// code, order and order_off; dims: C, n_shells, N, max_q, lo, side, num_tau, grey,
// depth, max_u; vals: dr, sig, minlogtau, dlogtau.
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

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y: cell order[k] of
// source b; out (B, C) = nHI at the cells' images.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_gather_kernel(Geom<T> g, const T* nhi, const int* pos, T* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (k >= g.C) return;
  int xyz[3];
  grid_xyz_ordered(g, pos + 3 * b, k, xyz);
  out[size_t(b) * g.C + g.order[k]] = nhi[flat_index(xyz, g.N)];
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
// wait: per corner k, where it is (n[k] >= 0: read after the wait) and its
// weight s = x[k], or (n[k] < 0) its term c w = x[k] and its weight w = w[k]
// formed before (0 and 0 for a corner of zero weight); diag and the cell's
// own column nHI path dr, formed as the plain version forms them.
template <typename T>
struct Operands {
  int n[4];
  T x[4], w[4];
  T diag, dcol;
};

// A thread's first cell of a shell, its operands as the tables hold them,
// copied into shared memory two shells ahead (kStage): two buffers by the
// shell's parity, each of nt of every field, field after field.
template <typename T>
struct Stage {
  T* v;       // [2][7][nt]: sw 0..3, path, diag, nhi
  int* c;     // [2][4][nt]: the corners' codes
  int nt;
  __device__ __forceinline__ T* val(int q, int f) const {
    return v + (size_t(q & 1) * 7 + f) * nt + threadIdx.x;
  }
  __device__ __forceinline__ int* code(int q, int k) const {
    return c + (size_t(q & 1) * 4 + k) * nt + threadIdx.x;
  }
};

// Bytes of shared memory the stage takes beside the ring.
template <typename T>
__host__ __device__ constexpr int stage_bytes(int nt) {
  return 2 * nt * (7 * int(sizeof(T)) + 4 * int(sizeof(int)));
}

// One source's sweep by one cluster.
template <typename T, int F>
struct Sweep {
  static constexpr bool kRingForm = (F & kRing) != 0;
  static constexpr bool kByCode = (F & (kRing | kCodes)) != 0;
  Geom<T> g;
  const T* nhi;     // the grid
  const T* no;      // the source's gathered nHI (C,), kPre
  const int* p;     // the source's position
  T* cd;            // the source's column densities (C,)
  T* ring;          // this block's ring: depth slots of cap values
  Stage<T> st;      // this block's stage (kStage)
  int lgC, rank, cap, nt;

  // This thread's cells start + l of shell q, l in [first, end) by
  // `stride`: a contiguous slice of the shell a block, at `lo` (ring), or
  // round robin over the cluster's threads.
  __device__ __forceinline__ void cells(int q, int& start, int& first,
                                        int& end, int& stride,
                                        int& lo) const {
    start = g.shell[q];
    const int n = g.shell[q + 1] - start;
    if (kRingForm) {
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
    if (!kRingForm) return g.shell[q2] + chunk * u + off;
    const int per_lg = 4 - lgC;              // log2 of chunks a block
    const int slot = q2 % g.depth;
    return (chunk >> per_lg) << 24 |
           (slot * cap + (chunk & ((1 << per_lg) - 1)) * u + off);
  }

  __device__ __forceinline__ T corner(int n) const {
    if (n < 0 || (F & kNoCorner)) return T(0);
    if (!kRingForm) return __ldcg(cd + n);
    const unsigned r = unsigned(n) >> 24;
    if ((F & kLocal) && r == unsigned(rank)) return ring[n & 0xffffff];
    return *cooperative_groups::this_cluster().map_shared_rank(
        ring + (n & 0xffffff), r);
  }

  // The corner term c w and the weight w = s / max(c sig, 0.6).
  __device__ __forceinline__ void term(T c, T s, T& x, T& w) const {
    const T m = clamp_min(mul(c, g.sig), static_cast<T>(0.6));
    w = (F & kNoDiv) ? mul(s, m) : div(s, m);
    x = mul(c, w);
  }

  // The operands of a cell of shell q from its corner codes (or cells, a
  // cell of shell `start` onwards reading 0), weights, path, diag and nHI.
  __device__ __forceinline__ void prepare(int q, int start, const int* c,
                                          const T* s, T path, T diag, T v,
                                          Operands<T>& o) const {
    for (int k = 0; k < 4; ++k) {
      int n;
      if (kByCode) {
        n = where(c[k], q);
        if ((F & kEarly) && (c[k] < 0 || c[k] >> 20 >= 2)) {
          // zero weight: the term and the weight are +0, as the plain
          // version's c 0 and 0 / max(c sig, 0.6) for finite c >= 0
          if (c[k] < 0) {
            o.x[k] = o.w[k] = T(0);
          } else {
            term(corner(n), s[k], o.x[k], o.w[k]);
          }
          n = -1;
        }
      } else {
        n = c[k] < start ? c[k] : -1;
      }
      o.n[k] = n;
      if (n >= 0 || !(F & kEarly)) o.x[k] = s[k];
    }
    o.dcol = mul(v, mul(path, g.dr));
    o.diag = diag;
  }

  // The operands of cell i of shell q, loaded from the tables.
  __device__ __forceinline__ void load(int q, int start, int i,
                                       Operands<T>& o) const {
    if (F & kNoLoad) {
      for (int k = 0; k < 4; ++k) {
        o.n[k] = -1;
        o.x[k] = o.w[k] = T(0.25) * T(i & 3);
      }
      o.dcol = T(i);
      o.diag = T(1);
      return;
    }
    int c[4];
    T s[4];
    for (int k = 0; k < 4; ++k) {
      c[k] = kByCode ? g.code[size_t(k) * g.C + i]
                     : g.nbr[size_t(k) * g.C + i];
      s[k] = g.sw[size_t(k) * g.C + i];
    }
    T v;
    if (F & kPre) {
      v = __ldcg(no + i);
    } else {
      int xyz[3];
      grid_xyz(g, p, i, xyz);
      v = nhi[flat_index(xyz, g.N)];
    }
    prepare(q, start, c, s, g.path[i], g.diag[i], v, o);
  }

  // Copies this thread's first cell of shell q (if it has one) into the
  // stage, and closes the group.
  __device__ __forceinline__ void stage(int q) const {
    if (q <= g.n_shells) {
      int start, first, end, stride, lo;
      cells(q, start, first, end, stride, lo);
      if (first < end) {
        const int i = start + first;
        for (int k = 0; k < 4; ++k) {
          copy_async<4>(st.code(q, k), g.code + size_t(k) * g.C + i);
          copy_async<sizeof(T)>(st.val(q, k), g.sw + size_t(k) * g.C + i);
        }
        copy_async<sizeof(T)>(st.val(q, 4), g.path + i);
        copy_async<sizeof(T)>(st.val(q, 5), g.diag + i);
        copy_async<sizeof(T)>(st.val(q, 6), no + i);
      }
    }
    copy_commit();
  }

  // The operands of this thread's first cell of shell q from the stage.
  __device__ __forceinline__ void fetch(int q, int start,
                                        Operands<T>& o) const {
    int c[4];
    T s[4];
    for (int k = 0; k < 4; ++k) {
      c[k] = *st.code(q, k);
      s[k] = *st.val(q, k);
    }
    prepare(q, start, c, s, *st.val(q, 4), *st.val(q, 5), *st.val(q, 6), o);
  }

  // The outgoing column density of a cell: cdin = diag sum(c w) / sum(w),
  // w = sw / max(c sig, 0.6), plus nHI path dr; the terms of the corners
  // read before the wait taken as they were formed.
  __device__ __forceinline__ T outgoing(const Operands<T>& o) const {
    T num = T(0), den = T(0);
    for (int k = 0; k < 4; ++k) {
      T x = o.x[k], w = o.w[k];
      if (o.n[k] >= 0 || !(F & kEarly)) term(corner(o.n[k]), o.x[k], x, w);
      num = add(num, x);
      den = add(den, w);
    }
    return add((F & kNoDiv) ? mul(mul(o.diag, num), den)
                            : div(mul(o.diag, num), den), o.dcol);
  }

  // Cell i of the shell; `at` its place in this block's slot `slot`.
  __device__ __forceinline__ void put(int i, int at, T v) const {
    if (kRingForm) {
      ring[at] = v;
      if (!(F & kNoOut)) cd[i] = v;
    } else {
      __stcg(cd + i, v);
    }
  }
};

// Cluster s = blockIdx.x >> lgC sweeps source s of the batch (at pos[s],
// in [0, N)^3) into row s of cd (B, C), reading row s of nhi_octa (the
// gathered nHI) with kPre; with kPrologue it gathers that row first, in
// grid order. Every thread of the cluster passes the same barriers.
template <typename T, int F>
__global__ void __launch_bounds__(kSweepThreads, 1)
flat_sweep_kernel(Geom<T> g, const T* nhi, const int* pos, T* nhi_octa,
                  T* cd_all, int lgC) {
  const int src = blockIdx.x >> lgC, rank = blockIdx.x & ((1 << lgC) - 1);
  const int nt = blockDim.x, t = threadIdx.x;
  if (F & kBare) {
    for (int q = 0; q <= g.n_shells; ++q) {
      cheb::cluster_arrive();
      cheb::cluster_wait();
    }
    return;
  }
  const int per = kChunks >> lgC;           // chunks a block holds
  int p[3];
  for (int k = 0; k < 3; ++k) p[k] = pos[3 * src + k];
  if (F & kPrologue) {
    // the source's nHI, gathered in grid order; a whole barrier publishes
    // it to the cluster before any thread loads operands
    // (kGatherCells cells a thread at a time, their loads in flight
    // together)
    T* no = nhi_octa + size_t(src) * g.C;
    const int stride = nt << lgC;
    for (int k0 = rank * nt + t; k0 < g.C; k0 += kGatherCells * stride) {
      long long at[kGatherCells];
      T v[kGatherCells];
#pragma unroll
      for (int j = 0; j < kGatherCells; ++j) {
        const int k = k0 + j * stride;
        int xyz[3];
        if (k < g.C) grid_xyz_ordered(g, p, k, xyz);
        at[j] = k < g.C ? flat_index(xyz, g.N) : -1;
      }
#pragma unroll
      for (int j = 0; j < kGatherCells; ++j)
        if (at[j] >= 0) v[j] = nhi[at[j]];
#pragma unroll
      for (int j = 0; j < kGatherCells; ++j)
        if (at[j] >= 0) no[g.order[k0 + j * stride]] = v[j];
    }
    cheb::cluster_arrive();
    cheb::cluster_wait();
  }
  T* smem = cheb::shared_mem<T>();
  const int cap = per * g.max_u;
  T* st_v = smem + ((F & kRing) ? size_t(g.depth) * cap : 0);
  const Sweep<T, F> S{g, nhi, nhi_octa + size_t(src) * g.C, p,
                      cd_all + size_t(src) * g.C,
                      (F & kRing) ? smem : nullptr,
                      Stage<T>{st_v, reinterpret_cast<int*>(st_v + 14 * nt),
                               nt},
                      lgC, rank, cap, nt};
  if (F & kStage) {
    S.stage(1);
    S.stage(2);
  }
  if (rank == 0 && t == 0) {
    // the source cell, shell 0 (slot 0): coldensh_in = 0 over half a cell
    // (path[0] = 0.5)
    int xyz[3];
    grid_xyz(g, p, 0, xyz);
    S.put(0, 0, mul(nhi[flat_index(xyz, g.N)], mul(g.path[0], g.dr)));
  }
  cheb::cluster_arrive();
  constexpr int A = (F & kAhead) ? kAheadCells : 1;
  for (int q = 1; q <= g.n_shells; ++q) {
    int start, first, end, stride, lo;
    S.cells(q, start, first, end, stride, lo);
    const int slot = (F & kRing) ? (q % g.depth) * cap : 0;
    Operands<T> o[A];
    if (F & kStage) {
      copy_wait_all_but_one();             // shell q's stage has landed
      if (first < end) S.fetch(q, start, o[0]);
    }
#pragma unroll
    for (int a = (F & kStage) ? 1 : 0; a < A; ++a)
      if (first + a * stride < end)
        S.load(q, start, start + first + a * stride, o[a]);
    cheb::cluster_wait();        // shells q - depth + 1 .. q - 1 are written
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int l = first + a * stride;
      if (l < end) S.put(start + l, slot + l - lo, S.outgoing(o[a]));
    }
    for (int l = first + A * stride; l < end; l += stride) {
      Operands<T> x;
      S.load(q, start, start + l, x);
      S.put(start + l, slot + l - lo, S.outgoing(x));
    }
    cheb::cluster_arrive();
    if (F & kStage) S.stage(q + 2);        // into the buffer shell q used
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

// The first port's accumulate, for the probe's measurement only: thread k
// of row b is cell k of source b (shell order), and the owner issues every
// covering source's atomicAdd into the grid in source order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_accumulate_atomic_kernel(Geom<T> g, AccIO<T> a) {
  const int* ps = a.pos;
  const int i = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (i >= g.C) return;
  int xyz[3];
  grid_xyz(g, ps + 3 * b, i, xyz);
  for (int b2 = 0; b2 < b; ++b2)
    if (cell_at(g, ps + 3 * b2, xyz, true) >= 0) return;
  const long long cell = flat_index(xyz, g.N);
  atomicAdd(a.phi_grid + cell, a.phi[size_t(b) * g.C + i]);
  for (int b2 = b + 1; b2 < a.B; ++b2) {
    const int j = cell_at(g, ps + 3 * b2, xyz, false);
    if (j >= 0) atomicAdd(a.phi_grid + cell, a.phi[size_t(b2) * g.C + j]);
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
  T* nhi_octa;              // (B, C) scratch: the gathered nHI
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
         B <= kMaxBatch && g.depth >= 2 && g.max_u >= 1 &&
         !(g.grey && heat) && (g.grey || (g.tab[0] && g.tab[1])) &&
         (!heat || (g.tab[2] && g.tab[3]));
}

// Bytes of a block's ring in a cluster of `cluster` blocks.
template <typename T>
int ring_bytes(const Geom<T>& g, int cluster) {
  return int(size_t(g.depth) * (kChunks / cluster) * g.max_u * sizeof(T));
}

template <typename T>
int launch_gather(const Geom<T>& g, const T* nhi, const int* pos, T* out,
                  int B, cudaStream_t st) {
  const dim3 grid((g.C + kThreads - 1) / kThreads, B);
  flat_gather_kernel<T><<<grid, kThreads, 0, st>>>(g, nhi, pos, out);
  return static_cast<int>(cudaGetLastError());
}

// B clusters of `cluster` blocks of kSweepThreads threads of the form F
// (or, with max_clusters, only ask how many of them the card holds at
// once); the ring in dynamic shared memory for kRing.
template <typename T, int F>
int launch_sweep_form(const Geom<T>& g, const T* nhi, const int* pos,
                      T* nhi_octa, T* cd, int B, int cluster,
                      int* max_clusters, cudaStream_t st) {
  int lgC = 0;
  while ((1 << lgC) < cluster) ++lgC;
  if (cluster < 1 || cluster > kChunks || (1 << lgC) != cluster)
    return cudaErrorInvalidValue;
  const int smem = ((F & kRing) ? ring_bytes(g, cluster) : 0) +
                   ((F & kStage) ? stage_bytes<T>(kSweepThreads) : 0);
  if (((F & kRing) && (g.depth - 1) * (kChunks / cluster) * g.max_u >=
                          (1 << 24)) || smem > 232448)
    return cudaErrorInvalidValue;
  const cheb::LaunchSpec spec{B, kSweepThreads, cluster, 0, smem, 0, 0,
                              max_clusters, st};
  return cheb::launch_cluster(flat_sweep_kernel<T, F>, spec, g, nhi, pos,
                              nhi_octa, cd, lgC);
}

// The engine's sweep: the ring (shared) or global placement.
template <typename T>
int launch_sweep(const Geom<T>& g, const T* nhi, const int* pos,
                 T* nhi_octa, T* cd, int B, int cluster, bool shared,
                 int* max_clusters, cudaStream_t st) {
  return shared ? launch_sweep_form<T, kShared>(g, nhi, pos, nhi_octa, cd, B,
                                                cluster, max_clusters, st)
                : launch_sweep_form<T, kGlobal>(g, nhi, pos, nhi_octa, cd, B,
                                                cluster, max_clusters, st);
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
  const size_t smem = sizeof(int) * (size_t(a.B) + 1);     // the near list
  if (a.heat)
    flat_accumulate_kernel<T, true><<<grid, kThreads, smem, st>>>(g, a);
  else
    flat_accumulate_kernel<T, false><<<grid, kThreads, smem, st>>>(g, a);
  return static_cast<int>(cudaGetLastError());
}

// The trace of ns sources, `dev_batch` of them at a time (consecutive
// sources in source order; the clusters the card holds at once): per device
// batch the gather, the sweep and the rate pass, then the ordered
// accumulate `acc_batch` sources at a time in source order, so every grid
// cell takes its adds in source order as the plain loop's batches give
// them. On `st`; returns the first error; a refused launch never runs.
template <typename T>
int trace(const Geom<T>& g, const Trace<T>& tr, int ns, int dev_batch,
          int acc_batch, int cluster, bool shared, cudaStream_t st) {
  if (dev_batch < 1 || acc_batch < 1) return cudaErrorInvalidValue;
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
    if (rc == 0) rc = launch_rates<T>(g, c.rates(0), n, st);
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

// The probe's forms of the sweep (for the measurement of the design's
// steps): the first port's chain, the bare barriers, nHI pre-gathered (by
// the gather kernel, launched first, or by the sweep's prologue), the ring,
// both, and the engine's two forms with the gather kernel or the prologue.
// Only float64.
int launch_probe(const Geom<double>& g, const double* nhi, const int* pos,
                 double* nhi_octa, double* cd, int B, int cluster, int form,
                 cudaStream_t st) {
  if ((form & kPre) && !(form & kPrologue)) {
    const int rc = launch_gather<double>(g, nhi, pos, nhi_octa, B, st);
    if (rc != 0) return rc;
  }
#define FLAT_PROBE_FORM(F)                                                     \
  case F:                                                                      \
    return launch_sweep_form<double, F>(g, nhi, pos, nhi_octa, cd, B,          \
                                        cluster, nullptr, st);
  switch (form) {
    FLAT_PROBE_FORMS(FLAT_PROBE_FORM)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLAT_PROBE_FORM
}

}  // namespace flat

extern "C" {

// The entry points take the engine's tables as `tabs` (16 pointers), `dims`
// (10 ints) and `vals` (4 doubles) in make_geom's order, and
// return the first cudaError_t that is not cudaSuccess (an invalid size
// is cudaErrorInvalidValue, nothing launched).
//
// flat_gather: nHI of the octahedra of the B sources at pos (B, 3), int32
// in [0, N) (ops/flat_sweep.py::stage_positions), from the grid nhi (N^3)
// into out (B, C), in grid order.
// flat_sweep: the gather into nhi_octa (B, C), then the sweep of those
// sources over it into cd (B, C), as B clusters
// of `cluster` blocks of kSweepThreads threads with the column densities
// in the shared ring (`shared`) or in global memory; with max_clusters set,
// launches nothing and writes there how many of those clusters are
// resident at once.
// flat_rates: the rate pass of those sources from cd, with the fluxes flux
// (B,) and S* / dr^3 at sdr3 (on the device), into phi (and heat, where it
// is set) (B, C).
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
        g, static_cast<P>(nhi), pos, static_cast<TYPE*>(nhi_octa),             \
        static_cast<TYPE*>(cd), B, cluster, shared != 0, max_clusters, st);    \
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

// The sweep of form `form` (float64; flat::launch_probe), with the gather
// kernel first where the form reads nHI gathered and has no prologue, for
// the measurement of the design's steps.
int flat_sweep_probe(void* const* tabs, const int* dims, const double* vals,
                     const void* nhi, const int* pos, void* nhi_octa,
                     void* cd, int B, int cluster, int form, void* stream) {
  const flat::Geom<double> g = flat::make_geom<double>(tabs, dims, vals);
  if (!flat::fits(g, B, false)) return cudaErrorInvalidValue;
  return flat::launch_probe(g, static_cast<const double*>(nhi), pos,
                            static_cast<double*>(nhi_octa),
                            static_cast<double*>(cd), B, cluster, form,
                            static_cast<cudaStream_t>(stream));
}

// The probe's forms (FLAT_PROBE_FORMS) into out, at most n; returns their
// count.
int flat_sweep_forms(int* out, int n) {
  using namespace flat;
  const int forms[] = {
#define FLAT_FORM_ITEM(F) F,
      FLAT_PROBE_FORMS(FLAT_FORM_ITEM)
#undef FLAT_FORM_ITEM
  };
  const int count = int(sizeof(forms) / sizeof(forms[0]));
  for (int k = 0; k < count && k < n; ++k) out[k] = forms[k];
  return count;
}

// The first port's accumulate (flat_accumulate_atomic_kernel, float64, no
// heat channel) of phi into phi_grid, for the measurement of the redesign.
int flat_accumulate_probe(void* const* tabs, const int* dims,
                          const double* vals, const int* pos, const void* phi,
                          void* phi_grid, int B, void* stream) {
  const flat::Geom<double> g = flat::make_geom<double>(tabs, dims, vals);
  if (!flat::fits(g, B, false)) return cudaErrorInvalidValue;
  const flat::AccIO<double> a{pos, static_cast<const double*>(phi), nullptr,
                              static_cast<double*>(phi_grid), nullptr, B};
  const dim3 grid((g.C + flat::kThreads - 1) / flat::kThreads, B);
  flat::flat_accumulate_atomic_kernel<double>
      <<<grid, flat::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g, a);
  return static_cast<int>(cudaGetLastError());
}

const char* flat_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
