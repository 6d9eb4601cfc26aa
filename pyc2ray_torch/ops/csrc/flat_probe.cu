// The flat engine's forms that were measured and left out, for
// chip_smoke.py's tables of the design steps alone (only chip_smoke.py
// builds this source; the engine's library, flat_sweep.cu, holds the
// engine's kernels). Every form that computes its kernel's function gives
// the plain version's bits; the rest take parts of a step out on purpose
// and are timed only.
//
//   the sweep      the sweep's template with every form bit
//                  (FLAT_PROBE_FORMS): the first port's chain, the bare
//                  barriers, nHI gathered by the gather kernel or by the
//                  sweep's own prologue, the ring, the engine's two
//                  placements, two cells' operands ahead, the corners of lag
//                  >= 2 and their terms formed before the wait, a block's own
//                  corners read from its own shared memory, a cp.async stage
//                  two shells ahead, and the shell step with its divisions,
//                  corners, loads or output taken out.
//   the gather     the grid-order form (a thread a cell in grid order: reads
//                  along z, 8-byte stores scattered over the shells), a thread
//                  a cell in octahedral order reading the grid through the
//                  offsets (the pattern of torch.take without an index
//                  tensor), the first staged form (one load in flight a
//                  thread, the runs read from global memory) and the engine's
//                  staged kernel with other loads in flight a lane or blocks
//                  an SM.
//   the rate pass  the steps from the first form (a thread a cell and source,
//                  nHI read from the grid at the cell's image, every cell
//                  masked) to the engine's: nHI from the gathered nhi_octa
//                  (kOcta), the engine's list of rated cells (kList), K
//                  sources a thread, each tau's place in the tables formed
//                  once for every table (kShare).
//   the accumulate the first port's (the owner's atomicAdds in shell order).
//
// float64, the tables' rates (no grey form).

#include "flat_sweep.cuh"

namespace flat_probe {

using namespace flat;

constexpr int kAheadCells = 2;       // cells a thread loads ahead of a wait
constexpr int kGatherCells = 8;      // cells a thread of the sweep's
                                     // prologue gathers at a time

// Forms of the sweep kernel (bits): the engine's two (flat_sweep.cuh) are
// kShared and kGlobal.
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

// ---------------------------------------------------------------------------
// the gather's forms
// ---------------------------------------------------------------------------

// The grid-order form: thread (blockIdx.x, threadIdx.x) of row blockIdx.y
// takes cell order[k] of source b (grid order); out (B, C) = nHI at the
// cells' images.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_grid_order_kernel(Geom<T> g, const T* nhi, const int* pos, T* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (k >= g.C) return;
  int xyz[3];
  grid_xyz_ordered(g, pos + 3 * b, k, xyz);
  out[size_t(b) * g.C + g.order[k]] = nhi[flat_index(xyz, g.N)];
}

// A thread a cell in octahedral order: cell i of source b reads the grid
// at its image through the offsets.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_octa_kernel(Geom<T> g, const T* nhi, const int* pos, T* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (i >= g.C) return;
  int xyz[3];
  grid_xyz(g, pos + 3 * b, i, xyz);
  out[size_t(b) * g.C + i] = nhi[flat_index(xyz, g.N)];
}

// The first staged form: as the engine's flat_gather_kernel, but the
// block's runs and places read from global memory where a warp writes a
// run, and one load in flight a thread while it stages its rows (each
// value's row and column by a division). Needs g_cells values of dynamic
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_staged_first_kernel(Geom<T> g, const T* nhi, const int* pos, T* out) {
  const int* blk = g.gblk + size_t(kBlockInts) * blockIdx.x;
  const int d0 = blk[0], d1a = blk[1], nd1 = blk[2], d2lo = blk[3];
  const int pitch = blk[4], run0 = blk[5], nrun = blk[6];
  const int* p = pos + 3 * blockIdx.y;
  const int rad = g.max_q - (d0 < 0 ? -d0 : d0);
  const long long x = wrap_add(p[0], d0, g.N);
  T* s = cheb::shared_mem<T>();
  for (int e = threadIdx.x; e < nd1 * pitch; e += blockDim.x) {
    const int r = e / pitch, d1 = d1a + r, d2 = d2lo + (e - r * pitch);
    if ((d1 < 0 ? -d1 : d1) + (d2 < 0 ? -d2 : d2) <= rad)
      s[e] = nhi[(x * g.N + wrap_add(p[1], d1, g.N)) * g.N +
                 wrap_add(p[2], d2, g.N)];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  T* o = out + size_t(blockIdx.y) * g.C;
  for (int j = threadIdx.x >> 5; j < nrun; j += warps) {
    const int* run = g.grun + size_t(kRunInts) * (run0 + j);
    const int first = run[0], n = run[1];
    const uint16_t* at = g.gsoff + run[2];
    for (int k = lane; k < n; k += 32) o[first + k] = s[at[k]];
  }
}

// ---------------------------------------------------------------------------
// the sweep's forms
// ---------------------------------------------------------------------------

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
sweep_form_kernel(Geom<T> g, const T* nhi, const int* pos, T* nhi_octa,
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
// the rate pass's forms
// ---------------------------------------------------------------------------

constexpr int kOcta = 1;    // nHI from the gathered nhi_octa (else from the
                            // grid at the cell's image)
constexpr int kList = 2;    // the rated cells' list (else every cell,
                            // masked)
constexpr int kShare = 4;   // each tau's place formed once for every table

// The rate pass's forms, F | K << 4 (K sources a thread), in the order of
// chip_smoke.py's table: the first form, + kOcta, + kList, + K = 2, 4, 8, +
// kShare at K = 1, 2, 4, 8.
#define FLAT_RATE_FORMS(X)                                                     \
  X(0, 1) X(kOcta, 1) X(kOcta | kList, 1) X(kOcta | kList, 2)                 \
  X(kOcta | kList, 4) X(kOcta | kList, 8) X(kOcta | kList | kShare, 1)        \
  X(kOcta | kList | kShare, 2) X(kOcta | kList | kShare, 4)                   \
  X(kOcta | kList | kShare, 8)

// The first form's arithmetic of one cell of one source: every lookup of
// its own, the cell's `rated` bit in the mask.
template <typename T, bool HEAT>
__device__ __forceinline__ void rates_apart(const Geom<T>& g, T nhi, T cdo,
                                            T pdr, T prefact, bool rated,
                                            T& phi_out, T& heat_out) {
  const T dcol = mul(nhi, pdr);
  const T cdin = sub(cdo, dcol);
  const T tau_in = mul(cdin, g.sig), tau_out = mul(cdo, g.sig);
  const T dtau = mul(dcol, g.sig);
  const bool thick = dtau > static_cast<T>(flat::kTauPhotoLimit);
  T heat = T(0);
  const T phi = thick ? mul(prefact, sub(lookup(g, g.tab[1], tau_in),
                                         lookup(g, g.tab[1], tau_out)))
                      : mul(mul(prefact, dtau), lookup(g, g.tab[0], tau_in));
  if (HEAT)
    heat = thick ? mul(prefact, sub(lookup(g, g.tab[3], tau_in),
                                    lookup(g, g.tab[3], tau_out)))
                 : mul(mul(prefact, dtau), lookup(g, g.tab[2], tau_in));
  const bool mask = cdin <= static_cast<T>(flat::kMaxColdensH) && rated;
  const T nhi_safe = clamp_min(nhi, tiny<T>());
  phi_out = mask ? div(phi, nhi_safe) : T(0);
  heat_out = mask ? div(heat, nhi_safe) : T(0);
}

// Thread (blockIdx.x, threadIdx.x) of row blockIdx.y: cell j (or rated
// cell rcell[j], kList) of the sources K blockIdx.y + u, u < K; the grid
// nhi and the positions pos read where the form has no kOcta.
template <typename T, bool HEAT, int F, int K>
__global__ void __launch_bounds__(kThreads)
rates_form_kernel(Geom<T> g, RateIO<T> a, const T* nhi, const int* pos) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ((F & kList) ? g.n_rated : g.C)) return;
  const int i = (F & kList) ? g.rcell[j] : j;
  const int b0 = blockIdx.y * K, nb = min(K, a.B - b0);
  const T pdr = mul(g.path[i], g.dr), gm = g.geom[i], sdr3 = *a.sdr3;
  const bool rated = (F & kList) || g.rated[i];
  T v[K], c[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (u < nb) {
      const size_t k = size_t(b0 + u) * g.C + i;
      if (F & kOcta) {
        v[u] = a.nhi_octa[k];
      } else {
        int xyz[3];
        grid_xyz(g, pos + 3 * (b0 + u), i, xyz);
        v[u] = nhi[flat_index(xyz, g.N)];
      }
      c[u] = a.cd[k];
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (u < nb) {
      const size_t k = size_t(b0 + u) * g.C + i;
      const T prefact = mul(mul(a.flux[b0 + u], sdr3), gm);
      T phi, heat;
      if (F & kShare)
        cell_rates<T, false, HEAT>(g, v[u], c[u], pdr, prefact, phi, heat);
      else
        rates_apart<T, HEAT>(g, v[u], c[u], pdr, prefact, rated, phi, heat);
      a.phi[k] = phi;
      if (HEAT) a.heat[k] = heat;
    }
  }
}

// ---------------------------------------------------------------------------
// the accumulate's form
// ---------------------------------------------------------------------------

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

// The launches of the probe's forms

// The engine's gather kernel (flat_sweep.cuh, form 2), or the grid-order one
// (form 0), the octahedral-order one (form 1), the first staged one (form 3) or
// the engine's with other loads in flight a lane or blocks an SM (forms 4
// to 8: 8 or 16 loads; 4 loads and at least 1 block an SM, 4 and 8, 8 and
// 8).
int launch_gather(const Geom<double>& g, const double* nhi, const int* pos,
                  double* out, int B, cudaStream_t st, int form = 2) {
  if (form >= 2 && form <= 8) {
    using Kernel = void (*)(Geom<double>, const double*, const int*, double*);
    const Kernel kernels[] = {
        flat_gather_kernel<double>, gather_staged_first_kernel<double>,
        flat_gather_kernel<double, 8>, flat_gather_kernel<double, 16>,
        flat_gather_kernel<double, 4, 1>, flat_gather_kernel<double, 4, 8>,
        flat_gather_kernel<double, 8, 8>};
    const Kernel kernel = kernels[form - 2];
    const int smem = int(form != 3 ? gather_smem(g)
                                   : size_t(g.g_cells) * sizeof(double));
    const cudaError_t err =
        cheb::allow(reinterpret_cast<const void*>(kernel), smem, false);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(g.n_blk, B), kThreads, smem, st>>>(g, nhi, pos, out);
  } else if (form == 0 || form == 1) {
    const dim3 grid((g.C + kThreads - 1) / kThreads, B);
    if (form == 0)
      gather_grid_order_kernel<double><<<grid, kThreads, 0, st>>>(g, nhi, pos,
                                                                   out);
    else
      gather_octa_kernel<double><<<grid, kThreads, 0, st>>>(g, nhi, pos, out);
  } else {
    return cudaErrorInvalidValue;
  }
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
  return cheb::launch_cluster(sweep_form_kernel<T, F>, spec, g, nhi, pos,
                              nhi_octa, cd, lgC);
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
    const int rc = launch_gather(g, nhi, pos, nhi_octa, B, st);
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

// The rate pass of form `form` (F | K << 4 of FLAT_RATE_FORMS).
int launch_rates_form(const Geom<double>& g, const RateIO<double>& a,
                      const double* nhi, const int* pos, int form,
                      cudaStream_t st) {
#define FLAT_RATE_FORM(F, K)                                                   \
  if (form == ((F) | (K) << 4)) {                                              \
    const dim3 grid((((F) & kList ? g.n_rated : g.C) + kThreads - 1) /        \
                        kThreads,                                              \
                    (a.B + (K) - 1) / (K));                                    \
    if (a.heat)                                                                \
      rates_form_kernel<double, true, F, K>                                    \
          <<<grid, kThreads, 0, st>>>(g, a, nhi, pos);                         \
    else                                                                       \
      rates_form_kernel<double, false, F, K>                                   \
          <<<grid, kThreads, 0, st>>>(g, a, nhi, pos);                         \
    return static_cast<int>(cudaGetLastError());                              \
  }
  FLAT_RATE_FORMS(FLAT_RATE_FORM)
#undef FLAT_RATE_FORM
  return cudaErrorInvalidValue;
}

}  // namespace flat_probe

extern "C" {

// The sweep of form `form` (float64; launch_probe), with the engine's
// gather kernel first where the form reads nHI gathered and has no
// prologue, for the measurement of the design's steps.
int flat_sweep_probe(void* const* tabs, const int* dims, const double* vals,
                     const void* nhi, const int* pos, void* nhi_octa,
                     void* cd, int B, int cluster, int form, void* stream) {
  const flat::Geom<double> g = flat::make_geom<double>(tabs, dims, vals);
  if (!flat::fits(g, B, false)) return cudaErrorInvalidValue;
  return flat_probe::launch_probe(g, static_cast<const double*>(nhi), pos,
                                  static_cast<double*>(nhi_octa),
                                  static_cast<double*>(cd), B, cluster, form,
                                  static_cast<cudaStream_t>(stream));
}

// The probe's forms (FLAT_PROBE_FORMS) into out, at most n; returns their
// count.
int flat_sweep_forms(int* out, int n) {
  using namespace flat_probe;
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
  flat_probe::flat_accumulate_atomic_kernel<double>
      <<<grid, flat::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g, a);
  return static_cast<int>(cudaGetLastError());
}

// The gather of form `form` (0: grid order, 1: octahedral order, 2: the
// engine's staged kernel, 3: the first staged form, 4 to 8: the engine's
// with other loads in flight or blocks an SM) of the B sources at pos
// from nhi into out (B, C).
int flat_gather_probe(void* const* tabs, const int* dims, const double* vals,
                      const void* nhi, const int* pos, void* out, int B,
                      int form, void* stream) {
  const flat::Geom<double> g = flat::make_geom<double>(tabs, dims, vals);
  if (!flat::fits(g, B, false)) return cudaErrorInvalidValue;
  return flat_probe::launch_gather(g, static_cast<const double*>(nhi), pos,
                                   static_cast<double*>(out), B,
                                   static_cast<cudaStream_t>(stream), form);
}

// The rate pass of form `form` (FLAT_RATE_FORMS: F | K << 4) of the B
// sources at pos, from the grid nhi or their gathered nHI nhi_octa and
// their column densities cd, into phi (and heat) (B, C); the forms with the
// rated cells' list leave the other cells as they are.
int flat_rates_probe(void* const* tabs, const int* dims, const double* vals,
                     const void* nhi, const int* pos, const void* nhi_octa,
                     const void* flux, const void* sdr3, const void* cd,
                     void* phi, void* heat, int B, int form, void* stream) {
  const flat::Geom<double> g = flat::make_geom<double>(tabs, dims, vals);
  if (!flat::fits(g, B, heat != nullptr) || g.grey)
    return cudaErrorInvalidValue;
  using P = const double*;
  const flat::RateIO<double> a{static_cast<P>(nhi_octa), static_cast<P>(flux),
                               static_cast<P>(sdr3), static_cast<P>(cd),
                               static_cast<double*>(phi),
                               static_cast<double*>(heat), B};
  return flat_probe::launch_rates_form(g, a, static_cast<P>(nhi), pos, form,
                                       static_cast<cudaStream_t>(stream));
}

// The rate pass's forms (FLAT_RATE_FORMS) into out, at most n; returns
// their count.
int flat_rates_forms(int* out, int n) {
  using namespace flat_probe;
  const int forms[] = {
#define FLAT_RATE_ITEM(F, K) (F) | (K) << 4,
      FLAT_RATE_FORMS(FLAT_RATE_ITEM)
#undef FLAT_RATE_ITEM
  };
  const int count = int(sizeof(forms) / sizeof(forms[0]));
  for (int k = 0; k < count && k < n; ++k) out[k] = forms[k];
  return count;
}

const char* flat_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
