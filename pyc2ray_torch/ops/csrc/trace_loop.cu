// The batch loop of a Chebyshev-face trace on NVIDIA Hopper (sm_90a): the
// box extract, the ordered accumulate, and the loop that issues a whole
// trace in any sweep mode from the host side of the library.
//
// Counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
// raytrace_cheb.py: _trace_jit, the lax.scan over batches with
// _extract_boxes, the sweep mode (_sweep_pallas with _rates, or
// _sweep_fold_rates) and the per-source dynamic_update_slice accumulate),
// which XLA runs on the device with one host call per trace. No TPU kernel
// of its own: the extract and the accumulate are XLA's there; here they are
// the port's own kernels. Plain versions: pyc2ray_torch/ops/trace_loop.py::
// extract_chunk_ref (a stack of extract_boxes_ref) and add_boxes; of the
// loop, trace_loop.py::cheb_trace_sweep_ref.
//
//   extract_chunk_kernel     the (k, B, D, D, D) boxes of the extended frame
//                            at the box corners of k consecutive batches (a
//                            chunk), for up to kMaxChannels frames at once.
//   accumulate_boxes_kernel  adds a batch's B boxes of side D into the
//                            frame at corner + shift, source by source in
//                            batch order, for up to kMaxChannels frames.
//   trace_sweep              one extract per chunk of batches, then per
//                            batch on its slot of the chunk, all on one
//                            stream, nothing synchronizing with the host:
//                            K1 ->
//                            the dense rate pass (cheb_rates.cuh) ->
//                            accumulate at shift rb0 (the default mode,
//                            with do_heating the heat beside Gamma); the
//                            segmented sweep's start -> K2 x seg_K -> the
//                            rate pass -> accumulate (shell_segment); K1f
//                            -> accumulate (fuse_rates); K3 phase A ->
//                            phase B -> accumulate (fuse_fold, K3h with
//                            do_heating).
//   he_trace_sweep           the helium engine's trace: one extract of the
//                            three species' boxes per chunk of batches,
//                            then per batch three sweeps (K1, or the
//                            segmented sweep's start and K2 x seg_K, one per
//                            species at its threshold cross section) ->
//                            the three-species rate pass (cheb_rates_he.cuh)
//                            -> accumulate of its 3-4 channels at rb0; the
//                            counterpart of pyc2ray_tpu/ops/raytrace_he.py::
//                            HeRaytracer._trace_jit (jit + lax.fori_loop
//                            over batches). Plain version: trace_loop.py::
//                            he_trace_sweep_ref.
//   box_trace                the box engine's trace (box_sweep.cuh's
//                            kernels): a chunk's rate boxes zeroed once,
//                            then per device batch of consecutive sources
//                            the gather of nHI at the valid sheet cells and
//                            the sweep, per chunk of batches the rate pass
//                            into the chunk's rate boxes, and per batch of B
//                            the accumulate over the rated cells;
//                            the counterpart of pyc2ray_tpu/ops/
//                            raytrace_box.py::BoxRaytracer._trace_jit (jit +
//                            shell lax.fori_loop + batch lax.scan). Plain
//                            version: ops/raytrace_box.py::BoxRaytracer.
//                            box_trace_sweep_ref.
//
// Both kernels take the positions of the whole trace, (nb, B, 3) int32 on
// the device, and a batch index, so a trace copies its positions to the card
// once. The frame may be non-cubic (a halo-extended block of a domain
// decomposition): its three extents are arguments. The caller checks that
// every box lies inside the frame.
//
// The accumulate's order. The plain version adds box after box with a
// slice add, so a cell covered by several boxes of a batch (halos cluster:
// boxes overlap) receives their values in ascending box index. An atomicAdd
// would add them in the order the threads arrive. Here every target cell has
// one owner: the thread of the lowest-indexed box that covers it. The owner
// reads the cell, adds the value of every covering box in ascending index
// and writes it once; a thread whose cell a lower box covers does nothing.
// So each cell is read and written by one thread, the adds are the plain
// version's adds in its order, and the result is bit for bit the same in
// float32 and float64, whatever order the blocks run in.
//
// Bound. Both kernels move bytes and do next to no arithmetic: the extract
// reads B D^3 values of the frame and writes the boxes; the accumulate reads
// the boxes and reads and writes the union of their cells in the frame (B D^3
// when no two boxes overlap). At the EoR run's shape (B = 16, D = 24,
// float32) that is 1.8 MB and 2.7 MB a batch: 0.53 and 0.79 us at 3.35 TB/s,
// at the bench shape's clustered batch (B = 8, D = 64) 10.7 MB for the
// accumulate, 3.2 us.
//
// The extract's design for this card. In the loop one launch of one batch
// (3.7 us at the EoR shape, 13.2 at the bench's) paid a launch and a gap of
// 1-2 us, ended on a quarter-full pass of blocks, and had one load in
// flight a thread behind a 32-bit division per cell. The frame does not
// change within a trace and the positions of every batch are on the card,
// so the loop cuts the boxes of a chunk of up to trace_loop.chunk_size
// consecutive batches in one launch into a (k, B, D, D, D) buffer, and
// batch b's kernels read its slot. The chunk is one flat run of vectors of
// 16 bytes (V cells) of box rows: a thread loads four vectors, their cells
// from the frame at any alignment, before it stores them as aligned 16-byte
// stores, and the index arithmetic (row, box, plane, row in the plane) is
// three multiply-high divisions a vector. A form on the Tensor Memory
// Accelerator (tiles of planes by tensor map into shared memory, stored by
// bulk copies, on a copy of the frame pitched to 16 bytes) was built beside
// it and deleted: it faulted on the card (PERF.md §6).
//
// The accumulate's design for this card. Inside the trace loop the boxes
// come fresh from L2 and the frame's cells cold from device memory; what
// holds the accumulate back is the latency of the frame reads and the
// instructions a cell spends on its ownership and coverage tests, and, where
// halos cluster, the loads of the up to B boxes that cover a cell of the
// first box, which owns nearly every cell. One thread per box cell over the
// flattened B D^3 cells (2.1 M threads at the bench shape) ran 38-41 us per
// bench fuse_fold batch against 29 us for one block per box plane (PERF.md,
// kernel_ab.py). So block (g, b) takes a contiguous range of box b's cells,
// at most kRangesPerPlane ranges per plane of D^2 cells and no more blocks
// than the card holds at once (47-56 registers a thread: five blocks to an
// SM; a second wave of short blocks made the EoR shape's accumulate a
// third slower), and first marks the boxes that meet the range's bounding
// box in the frame, a bit per box, 32 to a word: a cell tests those alone,
// and none where no other box comes near. The corners of up to
// kStagedCorners boxes are staged in shared memory (of more, read from
// device memory: a kernel of its own, so that the staged form's tests
// compile to shared-memory loads, which a pointer to either would not); a
// cell's coverage, a 32-box word at a time, is computed once and shared by
// its channels. Per channel the owner issues the loads of up to kLoadChunk
// covering boxes, its own included, into registers before it adds any of
// them, in ascending order: a clustered cell pays about one load latency per
// chunk, not one per box. Index arithmetic is 32-bit within a box (D^3 <
// 2^31, checked by the caller) and 64-bit for box bases and the frame
// offset.
//
// The rate boxes of the unfused modes are 0 outside the rates table's
// rated cells (the dense rate pass writes only those, cheb_rates.cuh), and
// adding 0 leaves a frame cell as it is (the frames start at +0 and gain
// non-negative rates, so none holds -0). There the accumulate visits only
// the listed rated cells of every box (struct Visit: B n_valid cells, 43%
// of B D^3 at the bench shape) and skips the adds of 0: a box takes part at
// a frame cell where it covers it at a rated cell, the owner is the thread
// of the lowest such box, and it adds the values of all of them in
// ascending order. Of the plain version's adds only those of 0 are left
// out, so the frame is the same bit for bit. The box and frame bytes fall
// with the rated share (10.7 MB of 25 MB at the bench shape).

#include "box_sweep.cuh"
#include "cheb_rates.cuh"
#include "cheb_rates_he.cuh"
#include "cheb_sweep_kernels.cuh"
#include "cheb_sweep_rates.cuh"

namespace {

using namespace cheb;

constexpr int kMaxChannels = 4;   // frames moved by one launch
constexpr int kBoxThreads = 256;  // threads per block of the two kernels
constexpr int kStagedCorners = 1024;  // the accumulate stages the corners of
                                      // up to this many boxes in shared
                                      // memory (of more: reads them there)
constexpr int kLoadChunk = 8;     // loads an owner issues before it adds
constexpr int kRangesPerPlane = 2;  // the accumulate's blocks per box: this
                                    // many per plane of D^2 cells

// Up to kMaxChannels frames and their (B, D, D, D) boxes: channel ch moves
// between frame[ch] and box[ch]. The kernels index them in unrolled loops,
// so the pointers stay in registers (a loop to n would copy the arrays to
// the stack).
template <typename T>
struct Channels {
  T* frame[kMaxChannels];
  T* box[kMaxChannels];
  int n;
};

// One batch's boxes in a frame of extents (F0, F1, F2): box b of batch
// `batch` starts at pos[batch][b] + shift on every axis.
struct BoxSet {
  const int* pos;   // (nb, B, 3)
  int batch, B, D, shift;
  int F0, F1, F2;
  __device__ const int* corners() const {
    return pos + size_t(batch) * B * 3;
  }
  __device__ size_t at(int x, int y, int z) const {
    return (size_t(x + shift) * F1 + (y + shift)) * F2 + (z + shift);
  }
};

// Whether the box of corner p (side D) holds the cell (x, y, z) of the
// frame, all before the shift.
__device__ __forceinline__ bool covers(const int* p, int x, int y, int z,
                                       int D) {
  return unsigned(x - p[0]) < unsigned(D) && unsigned(y - p[1]) < unsigned(D) &&
         unsigned(z - p[2]) < unsigned(D);
}

// The cells of each box the accumulate visits: all D^3 (cells null), or
// the n rated cells `cells` (ascending flat indices), where `valid` (the
// rates table's valid channel, D^3 values) exceeds 0.5 and the boxes are 0
// everywhere else.
template <typename T>
struct Visit {
  const int* cells;
  const T* valid;
  int n;
};

// Whether the box of corner p takes part at frame cell (x, y, z): it
// covers it, at a cell it rates where the visit is a list.
template <typename T>
__device__ __forceinline__ bool takes_part(const int* p, int x, int y, int z,
                                           int D, const T* valid) {
  return covers(p, x, y, z, D) &&
         (valid == nullptr ||
          valid[(unsigned(x - p[0]) * D + unsigned(y - p[1])) * D +
                unsigned(z - p[2])] > T(0.5));
}

// x / d for 0 <= x < 2^31 by a multiply-high and a shift, d >= 1 (the
// round-up method: mul = ceil(2^(31 + l) / d), l = ceil(log2 d)).
struct FastDiv {
  unsigned d, mul, shift;
  FastDiv() = default;
  explicit FastDiv(unsigned div) : d(div), mul(0), shift(0) {
    unsigned l = 0;
    while ((1ull << l) < d) ++l;
    if (d > 1) {
      mul = unsigned(((1ull << (31 + l)) + d - 1) / d);
      shift = l - 1;
    }
  }
  __device__ __forceinline__ unsigned of(unsigned x) const {
    return d == 1 ? x : __umulhi(x, mul) >> shift;
  }
};

// The boxes of batches k0 .. k0 + k - 1 (a chunk): box bx of the chunk, bx
// = slot B + b, is box b of batch k0 + slot, with its corner at pos[k0 B +
// bx], and lands at bx D^3 of the (k, B, D, D, D) chunk buffer. The frames
// have strides (S0, S1, 1).
struct Chunk {
  const int* pos;   // (nb, B, 3)
  int k0, k, B, D;
  long long S0, S1;
  __device__ const int* corner(unsigned bx) const {
    return pos + (size_t(k0) * B + bx) * 3;
  }
};

constexpr int kExtractVecs = 4;   // vectors a thread loads before it stores

// V values of T as one aligned store (16 bytes where V > 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The extract. Thread t of block g copies the vectors
// g T U + u T + t (u < U = kExtractVecs) of V cells each of every channel's
// chunk (NC: 1 channel, or up to kMaxChannels; V = 16 bytes of T where D
// is a multiple of it, else 1): a vector lies in one row of a box, so its
// index arithmetic (row, box, plane and row in the plane: three
// multiply-high divisions) is done once for its V cells; the thread issues
// the loads of all its vectors, then their stores, each an aligned V-wide
// store into the contiguous chunk.
template <typename T, int V, int NC>
__global__ void __launch_bounds__(kBoxThreads)
    extract_chunk_kernel(Channels<T> ch, Chunk cs, FastDiv row_vecs,
                         FastDiv box_rows, FastDiv side, unsigned n_vec) {
  T got[NC][kExtractVecs][V];
  const unsigned q0 = blockIdx.x * (kBoxThreads * kExtractVecs) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kExtractVecs; ++u) {
    const unsigned q = q0 + u * kBoxThreads;
    if (q < n_vec) {
      const unsigned row = row_vecs.of(q);
      const unsigned z = (q - row * row_vecs.d) * V;
      const unsigned bx = box_rows.of(row);
      const unsigned r = row - bx * box_rows.d;
      const unsigned i = side.of(r), j = r - i * side.d;
      const int* p = cs.corner(bx);
      const long long src = (p[0] + i) * cs.S0 + (p[1] + j) * cs.S1 + p[2] + z;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (NC == 1 || c < ch.n)
#pragma unroll
          for (int v = 0; v < V; ++v) got[c][u][v] = ch.frame[c][src + v];
    }
  }
#pragma unroll
  for (int u = 0; u < kExtractVecs; ++u) {
    const unsigned q = q0 + u * kBoxThreads;
    if (q < n_vec) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (NC > 1 && c >= ch.n) break;
        Vec<T, V> w;
#pragma unroll
        for (int v = 0; v < V; ++v) w.v[v] = got[c][u][v];
        reinterpret_cast<Vec<T, V>*>(ch.box[c])[q] = w;
      }
    }
  }
}

// The extract's launch over the chunk `cs`: V cells a vector, the
// three divisors, the vectors and the blocks (kBoxThreads x kExtractVecs
// vectors each). n_vec is 0 where the chunk has 2^31 cells or more.
struct ExtractGrid {
  int V;
  FastDiv row_vecs, box_rows, side;
  unsigned n_vec, blocks;
};

template <typename T>
ExtractGrid extract_grid(const Chunk& cs) {
  constexpr int W = 16 / sizeof(T);
  const size_t n = size_t(cs.k) * cs.B * cs.D * cs.D * cs.D;
  ExtractGrid g{};
  g.V = cs.D % W == 0 ? W : 1;
  g.row_vecs = FastDiv(unsigned(cs.D / g.V));
  g.box_rows = FastDiv(unsigned(cs.D) * cs.D);
  g.side = FastDiv(unsigned(cs.D));
  g.n_vec = n < (size_t(1) << 31) ? unsigned(n / g.V) : 0u;
  g.blocks = (g.n_vec + kBoxThreads * kExtractVecs - 1) /
             (kBoxThreads * kExtractVecs);
  return g;
}

// v plus the value at frame cell (x, y, z) of every box whose bit is set in
// `mask` (bit q: box o0 + q, its corner at c + 3 q), in ascending box index:
// up to kLoadChunk loads are issued into registers, then added in order.
template <typename T>
__device__ __forceinline__ T add_covering(T v, const T* box, unsigned mask,
                                          const int* c, int o0, int x, int y,
                                          int z, int D, unsigned D3) {
  while (mask != 0u) {
    T got[kLoadChunk];
    int n = 0;
#pragma unroll
    for (int u = 0; u < kLoadChunk; ++u) {
      if (mask != 0u) {
        const int q = __ffs(mask) - 1;
        mask &= mask - 1u;
        const int* p = c + 3 * q;
        got[u] = box[size_t(o0 + q) * D3 +
                     (unsigned(x - p[0]) * D + unsigned(y - p[1])) * D +
                     unsigned(z - p[2])];
        n = u + 1;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadChunk; ++u)
      if (u < n) v = Arith<T>::add(v, got[u]);
  }
  return v;
}

// Block (g, b) visits the g-th of gridDim.x equal ranges of box b's
// visited cells, a thread one cell at a time at stride blockDim. First each
// warp marks in its `near` (a bit per box, 32 to a word) the boxes that
// meet the range's bounding box in the frame; a cell then tests those
// alone. A thread owns its frame cell when no box before b takes part
// there, and then adds the value of every box that does into it in
// ascending box index (see the head of this file). STAGED: the corners lie
// in shared memory (B <= kStagedCorners), else in device memory.
template <typename T, bool STAGED>
__global__ void accumulate_boxes_kernel(Channels<T> ch, BoxSet bs,
                                        Visit<T> vis) {
  const int B = bs.B, D = bs.D, b = blockIdx.y, words = (B + 31) / 32;
  const unsigned D2 = unsigned(D) * D, D3 = D2 * unsigned(D);
  const unsigned n = unsigned(vis.n), per = (n + gridDim.x - 1) / gridDim.x;
  const unsigned r0 = blockIdx.x * per, r1 = r0 + per < n ? r0 + per : n;
  if (r0 >= r1) return;
  // per warp its own copy of the near words (no second block barrier);
  // the staged corners behind them
  const int lane = threadIdx.x & 31;
  unsigned* near = shared_mem<unsigned>() + (threadIdx.x >> 5) * words;
  int* staged = reinterpret_cast<int*>(shared_mem<unsigned>() +
                                       ((blockDim.x + 31) >> 5) * words);
  const int* P = bs.corners();
  const int px = P[3 * b], py = P[3 * b + 1], pz = P[3 * b + 2];
  {  // the range's bounding box in the frame: planes i0..i1 of box b, its
     // rows j0..j1 where the range lies in one plane; lane l of each warp
     // tests box 32 w + l for word w
    const unsigned c0 = vis.cells ? unsigned(vis.cells[r0]) : r0;
    const unsigned c1 = vis.cells ? unsigned(vis.cells[r1 - 1]) : r1 - 1;
    const int i0 = int(c0 / D2), i1 = int(c1 / D2);
    const int j0 = i0 == i1 ? int(c0 - unsigned(i0) * D2) / D : 0;
    const int j1 = i0 == i1 ? int(c1 - unsigned(i1) * D2) / D : D - 1;
    const int width = min(32, int(blockDim.x) - (int(threadIdx.x) & ~31));
    for (int w = 0; w < words; ++w) {
      unsigned bits = 0u;
      for (int l0 = 0; l0 < 32; l0 += width) {   // once in a warp of 32
        const int q = 32 * w + l0 + lane;
        const int* c = P + 3 * q;
        const bool meets =
            l0 + lane < 32 && q < B && c[0] <= px + i1 && px + i0 < c[0] + D &&
            c[1] <= py + j1 && py + j0 < c[1] + D && c[2] < pz + D &&
            pz < c[2] + D;
        bits |= __ballot_sync(0xffffffffu, meets) << l0;
      }
      if (lane == 0) near[w] = bits;
    }
  }
  if (STAGED)
    for (int q = threadIdx.x; q < 3 * B; q += blockDim.x) staged[q] = P[q];
  __syncthreads();
  const int* C = STAGED ? staged : P;
  for (unsigned k = r0 + threadIdx.x; k < r1; k += blockDim.x) {
    const unsigned cell = vis.cells ? unsigned(vis.cells[k]) : k;
    const int i = int(cell / D2), jk = int(cell - unsigned(i) * D2);
    const int j = jk / D;
    const int x = px + i, y = py + j, z = pz + jk - j * D;
    bool owner = true;
    for (int w = 0; owner && w <= (b >> 5); ++w) {
      unsigned m = near[w];
      if (w == (b >> 5)) m &= (1u << (b & 31)) - 1u;      // boxes before b
      for (; owner && m != 0u; m &= m - 1u)
        owner = !takes_part(C + 3 * (32 * w + __ffs(m) - 1), x, y, z, D,
                            vis.valid);
    }
    if (!owner) continue;
    const size_t f = bs.at(x, y, z);
    T v[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (c < ch.n) v[c] = ch.frame[c][f];
    for (int w = b >> 5; w < words; ++w) {
      unsigned m = near[w], mask = 0u;
      if (w == (b >> 5)) {                     // box b and the boxes after it
        m &= ~((2u << (b & 31)) - 1u);
        mask = 1u << (b & 31);
      }
      for (; m != 0u; m &= m - 1u) {
        const int q = __ffs(m) - 1;
        if (takes_part(C + 3 * (32 * w + q), x, y, z, D, vis.valid))
          mask |= 1u << q;
      }
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < ch.n)
          v[c] = add_covering(v[c], ch.box[c], mask, C + 96 * w, 32 * w, x,
                              y, z, D, D3);
    }
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (c < ch.n) ch.frame[c][f] = v[c];
  }
}

// The pointers of a he_trace_sweep call beside the sweep's tables.
struct HeLoopBufs {
  const void* frames[kHeSpecies];   // n_HI, n_HeI, n_HeII (F0, F1, F2)
  const int* pos;           // (nb, B, 3) box corners
  const void* flux;         // (nb, B)
  const void* rt_sub;       // (3, Ds, Ds, Ds), the rate pass's table
  const int* cells;         // (n_valid,) the subbox cells it rates, ascending
  const void* rec;          // the rate pass's bins by band: the records and,
  const int* bands;         // on the host, their header (cheb_rates_he.cuh)
  void* out[kHeSpecies + 1];  // the rate frames, zeroed by the caller; the
                              // heat's null without the heat channel
  void* boxes;              // (3, chunk, B, Dc, Dc, Dc) scratch: the three
                            // species' boxes of a chunk of batches
  void* cd;                 // (3, B, Dc, Dc, Dc) scratch: the sweeps' boxes
  void* rates;              // (3 or 4, B, Ds^3) rate boxes, zeroed by the
                            // caller (the pass writes its listed cells only)
  void* planes[2];          // (B, 3, 2, Dc, Dc) each: K2's carried planes
  void* scratch;            // the sweep's planes where they are not shared
};

// The scalars of a he_trace_sweep call beside the sweep's launch arguments
// (whose sig is sigma_HI).
struct HeLoopArgs {
  int nb;
  double sdr3;              // S* / dr^3
  double sig_he[2];         // sigma_HeI, sigma_HeII of the second and third
                            // sweeps
  int rb0, Ds, n_valid;     // the rate pass's subbox and its rated cells
  int seg_S, seg_K;         // K2: shells per segment, segments (S = 0: K1)
  int F0, F1, F2;           // the frames' extents
  int chunk;                // batches a launch of the extract cuts
};

// The rate pass of a he_trace_sweep call but for each batch's absorber
// boxes and fluxes: the sweeps' cd boxes in, the rate boxes out (the heat's
// where the heat channel's frame is given).
template <typename T>
HeRates<T> he_rates_of(const HeLoopBufs& a, const HeLoopArgs& s, int B,
                       int Dc) {
  using P = const T*;
  const size_t box_vals = size_t(B) * Dc * Dc * Dc;
  const size_t rate_vals = size_t(B) * s.Ds * s.Ds * s.Ds;
  const int n_out = a.out[kHeSpecies] != nullptr ? kHeSpecies + 1
                                                  : kHeSpecies;
  HeRates<T> hr{};
  for (int sp = 0; sp < kHeSpecies && a.cd; ++sp)
    hr.cd[sp] = static_cast<P>(a.cd) + sp * box_vals;
  for (int ch = 0; ch < n_out && a.rates; ++ch)
    hr.out[ch] = static_cast<T*>(a.rates) + ch * rate_vals;
  hr.rt = static_cast<P>(a.rt_sub);
  hr.cells = a.cells;
  hr.rec = static_cast<P>(a.rec);
  hr.bands = he_bands_of(a.bands);
  hr.B = B;
  hr.Dc = Dc;
  hr.Ds = s.Ds;
  hr.rb0 = s.rb0;
  hr.n_valid = s.n_valid;
  hr.sdr3 = static_cast<T>(s.sdr3);
  return hr;
}

// Whether a he_trace_sweep call's buffers and sizes are ones the loop
// takes: every frame, box buffer and table given, a list of rated cells,
// boxes inside a frame of at least Dc a side, K2's segments and planes
// where it segments, a chunk's cells below 2^31, and a rate pass
// he_rates_fit takes (the heat channel's records where it has its frame
// and not where it has none).
template <typename T>
bool he_loop_fits(const HeLoopBufs& a, const HeLoopArgs& s, int B, int Dc,
                  int c, int R1) {
  const size_t D3 = size_t(Dc) * Dc * Dc;
  bool given = a.pos && a.flux && a.rt_sub && a.cells && a.bands &&
               a.boxes && a.cd && a.rates;
  for (int sp = 0; sp < kHeSpecies; ++sp)
    given = given && a.frames[sp] && a.out[sp];
  return given && s.nb >= 0 &&
         s.chunk >= 1 && B <= 65535 && c >= 0 && c < Dc && R1 >= 1 &&
         s.n_valid >= 1 && s.seg_S >= 0 &&
         (s.seg_S == 0 || (s.seg_K >= 1 && a.planes[0] && a.planes[1])) &&
         s.F0 >= Dc && s.F1 >= Dc && s.F2 >= Dc &&
         size_t(s.chunk) * B * D3 < (size_t(1) << 31) &&
         he_rates_fit(he_rates_of<T>(a, s, B, Dc));
}

// The launches of the two kernels and of the trace loop.

// How many blocks of the accumulate the card holds at once (its registers
// decide it: 47-56 a thread, so five blocks of 256 threads to an SM), asked
// once per form.
template <typename T, bool STAGED>
size_t resident_blocks(size_t smem) {
  static const size_t n = [smem] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, accumulate_boxes_kernel<T, STAGED>, kBoxThreads, smem);
    return size_t(per_sm > 0 ? per_sm : 1) * size_t(sms > 0 ? sms : 1);
  }();
  return n;
}

// The accumulate of the cells `vis` visits (all of them where vis.cells is
// null) on `st`; returns the first cudaError_t that is not cudaSuccess.
template <typename T>
int launch_accumulate(const Channels<T>& ch, const BoxSet& bs, Visit<T> vis,
                      cudaStream_t st) {
  const size_t D3 = size_t(bs.D) * bs.D * bs.D;
  if (vis.cells == nullptr) vis.n = int(D3 < (size_t(1) << 31) ? D3 : 0);
  if (ch.n < 1 || ch.n > kMaxChannels || bs.B < 1 || bs.B > 65535 ||
      bs.D < 1 || D3 >= (size_t(1) << 31) || vis.n < 0 ||
      size_t(vis.n) > D3 || (vis.cells == nullptr) != (vis.valid == nullptr))
    return cudaErrorInvalidValue;
  if (vis.n > 0) {
    // ranges of at least a cell a thread, at most kRangesPerPlane a plane,
    // and no more blocks than the card holds at once
    const bool staged = bs.B <= kStagedCorners;
    const size_t smem =
        sizeof(unsigned) * (kBoxThreads / 32) * ((bs.B + 31) / 32) +
        (staged ? 3 * sizeof(int) * bs.B : 0);
    const size_t cap[3] = {
        (size_t(vis.n) + kBoxThreads - 1) / kBoxThreads,
        size_t(kRangesPerPlane) * bs.D,
        (staged ? resident_blocks<T, true>(smem)
                : resident_blocks<T, false>(smem)) / size_t(bs.B)};
    size_t ranges = cap[0];
    for (const size_t c : cap) ranges = c < ranges ? c : ranges;
    const dim3 grid(unsigned(ranges > 0 ? ranges : 1), unsigned(bs.B));
    if (staged)
      accumulate_boxes_kernel<T, true><<<grid, kBoxThreads, smem, st>>>(
          ch, bs, vis);
    else
      accumulate_boxes_kernel<T, false><<<grid, kBoxThreads, smem, st>>>(
          ch, bs, vis);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, int NC>
void extract_chunk(const Channels<T>& ch, const Chunk& cs,
                   const ExtractGrid& g, cudaStream_t st) {
  extract_chunk_kernel<T, V, NC><<<g.blocks, kBoxThreads, 0, st>>>(
      ch, cs, g.row_vecs, g.box_rows, g.side, g.n_vec);
}

// The extract of the chunk `cs` on `st`: one block per
// kBoxThreads x kExtractVecs vectors.
template <typename T>
int launch_extract(const Channels<T>& ch, const Chunk& cs, cudaStream_t st) {
  if (ch.n < 1 || ch.n > kMaxChannels || cs.k < 1 || cs.B < 1 || cs.D < 1)
    return cudaErrorInvalidValue;
  const ExtractGrid g = extract_grid<T>(cs);
  if (g.n_vec == 0) return cudaErrorInvalidValue;
  constexpr int W = 16 / sizeof(T);
  if (ch.n == 1 && g.V == W)
    extract_chunk<T, W, 1>(ch, cs, g, st);
  else if (ch.n == 1)
    extract_chunk<T, 1, 1>(ch, cs, g, st);
  else if (g.V == W)
    extract_chunk<T, W, kMaxChannels>(ch, cs, g, st);
  else
    extract_chunk<T, 1, kMaxChannels>(ch, cs, g, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Channels<T> channels(void* const* frames, void* const* boxes, int n) {
  Channels<T> ch{};
  ch.n = n;
  for (int c = 0; c < n && c < kMaxChannels; ++c) {
    ch.frame[c] = static_cast<T*>(frames[c]);
    ch.box[c] = static_cast<T*>(boxes[c]);
  }
  return ch;
}

// The sweep modes of trace_sweep: the sweep K1 or K2 then the dense rate
// pass, K1f with its rates inside, or K3 (K3h with the heat channel) with
// sweep, box and rates fused.
enum SweepMode { kSweepK1 = 0, kSweepK2 = 1, kSweepK1f = 2, kSweepK3 = 3 };

// The pointers of a trace_sweep call beside the sweep's tables.
struct SweepLoopBufs {
  const void* frame;      // the nHI frame (F0, F1, F2)
  const int* pos;         // (nb, B, 3) box corners
  const void* flux;       // (nb, B)
  const void* rt_tab;     // (Dc, 2, Dc, Dc), the rates table of K1f and K3
  const void* rt_sub;     // (3, Ds, Ds, Ds), the rate pass's table
  const int* cells;       // (n_valid,) the subbox cells it rates, ascending
  const void* bins_s;
  const void* bins_w;
  const void* bins_wh;    // null without the heat channel
  void* phi_frame;        // zeroed by the caller
  void* heat_frame;       // null without the heat channel
  void* boxes;            // (chunk, B, Dc, Dc, Dc) scratch: the nHI boxes
                          // of a chunk of batches
  void* work[2];          // (B, Dc, Dc, Dc) scratch each: the sweep's box
                          // (K1, K2) in work[0]; K3's cdin and dcol boxes
  void* phi;              // (B, Ds^3) rate boxes, zeroed by the caller
                          // (the rate pass writes its listed cells only);
                          // (B, Dc^3) with K1f, K3
  void* heat;             // the same, null without the heat channel
  void* planes[2];        // (B, 3, 2, Dc, Dc) each: K2's carried planes
  void* scratch;          // the sweep's planes where they are not shared
};

// The scalars of a trace_sweep call beside the sweep's launch arguments.
struct SweepLoopArgs {
  int nb, mode, E;
  double R2;              // K1f: the squared radius
  double sdr3, s_fac;     // S* / dr^3, and S* dr / dr^3 (K3)
  int threads_b;          // K3's phase B: threads per block
  int rb0, Ds, n_valid;   // the rate pass's subbox and its rated cells
  int seg_S, seg_K;       // K2: shells per segment, segments
  int F0, F1, F2;         // the frame's extents
  int chunk;              // batches a launch of the extract cuts
};

// The trace of nb batches in sweep mode `mode` (see SweepMode): per chunk
// of s.chunk batches one extract of their nHI boxes out of the frame, then
// per batch the mode's sweep and rates on its slot of the chunk, and the
// accumulate of the rate boxes into phi_frame (and heat_frame). The tables,
// the plan and the rate pass's constants are made once. With
// spec.max_clusters only ask how many of the sweep's clusters (K3: of its
// phase A) fit.
template <typename T>
int trace_sweep(const SweepLoopBufs& a, const SweepLoopArgs& s,
                const void* sw, const void* path, const void* diag,
                const void* mask_m, const void* mask_p, int Dc, int c, int R1,
                double dr, double sig, const LaunchSpec& spec) {
  const cudaStream_t st = static_cast<cudaStream_t>(spec.stream);
  const Tables<T> tb = make_tables<T>(sw, path, diag, mask_m, mask_p, Dc, c,
                                      R1, dr, sig);
  const int mode = s.mode;
  const bool gamma = mode == kSweepK1f, whole = mode >= kSweepK1f;
  const bool with_heat = a.heat_frame != nullptr;
  if (mode < kSweepK1 || mode > kSweepK3 || (gamma && with_heat) ||
      (a.heat != nullptr) != with_heat || (a.bins_wh != nullptr) != with_heat ||
      (mode == kSweepK2 && (s.seg_S < 1 || s.seg_K < 1 || !a.planes[0] ||
                            !a.planes[1])) ||
      (mode == kSweepK3 && !a.work[1]) ||
      (!whole && s.n_valid > 0 && a.cells == nullptr) || s.chunk < 1)
    return cudaErrorInvalidValue;
  Plan pl;
  const cudaError_t err = make_plan<T>(spec, Dc, gamma ? 2 * s.E : 0, gamma,
                                       &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  using P = const T*;
  P nhi = static_cast<P>(a.boxes), fl = static_cast<P>(a.flux);
  P rt_tab = static_cast<P>(a.rt_tab);
  P bins_s = static_cast<P>(a.bins_s), bins_w = static_cast<P>(a.bins_w);
  T* cd = static_cast<T*>(a.work[0]);
  T* phi = static_cast<T*>(a.phi);
  T* const planes[2] = {static_cast<T*>(a.planes[0]),
                        static_cast<T*>(a.planes[1])};
  T* sc = static_cast<T*>(a.scratch);
  RatesCall<T> k3{nhi, rt_tab, bins_s, bins_w, static_cast<P>(a.bins_wh), fl,
                  phi, static_cast<T*>(a.heat), cd,
                  static_cast<T*>(a.work[1]), sc, s.E, s.threads_b,
                  static_cast<T>(s.s_fac), static_cast<T>(s.sdr3)};
  if (spec.max_clusters != nullptr) {
    if (gamma)
      return launch_gamma<T>(tb, pl, spec, nhi, rt_tab, fl, bins_s, bins_w,
                             s.E, T(s.R2), T(s.sdr3), phi, sc);
    if (mode == kSweepK2)
      return launch_seg<T>(tb, pl, spec, nhi, planes[0], planes[1], 1, 1, cd,
                           sc);
    if (mode == kSweepK3) return launch_rates<T>(tb, pl, spec, k3);
    return launch_sweep<T>(tb, pl, spec, nhi, cd, sc);
  }
  DenseRates<T> rates{cd, nhi, static_cast<P>(a.rt_sub), a.cells, fl,
                      bins_s, bins_w, static_cast<P>(a.bins_wh), phi,
                      static_cast<T*>(a.heat), spec.B, s.E, Dc, s.Ds, s.rb0,
                      s.n_valid, static_cast<T>(dr), static_cast<T>(sig),
                      static_cast<T>(s.sdr3)};
  void* src[1] = {const_cast<void*>(a.frame)};
  void* nhi_box[1] = {a.boxes};
  void* frames[2] = {a.phi_frame, a.heat_frame};
  void* out[2] = {a.phi, a.heat};
  const Channels<T> in = channels<T>(src, nhi_box, 1);
  const size_t box_vals = size_t(spec.B) * Dc * Dc * Dc;
  Chunk chunk{a.pos, 0, s.chunk, spec.B, Dc, (long long)s.F1 * s.F2, s.F2};
  const Channels<T> acc = channels<T>(frames, out, with_heat ? 2 : 1);
  // the unfused modes accumulate the rate pass's cells only; the fused
  // ones every cell of their (Dc)^3 boxes
  const Visit<T> rated{whole ? nullptr : a.cells,
                       whole ? nullptr
                             : static_cast<P>(a.rt_sub) +
                                   2 * size_t(s.Ds) * s.Ds * s.Ds,
                       whole ? 0 : s.n_valid};
  BoxSet ac{a.pos, 0, spec.B, whole ? Dc : s.Ds, whole ? 0 : s.rb0,
            s.F0, s.F1, s.F2};
  for (int b = 0; b < s.nb; ++b) {
    ac.batch = b;
    const T* flux_b = fl + size_t(b) * spec.B;
    const int slot = b % s.chunk;
    int rc = 0;
    if (slot == 0) {
      // the boxes of batches b .. b + k - 1 in one launch
      chunk.k0 = b;
      chunk.k = s.nb - b < s.chunk ? s.nb - b : s.chunk;
      rc = launch_extract<T>(in, chunk, st);
    }
    // batch b's boxes: its slot of the chunk
    nhi = static_cast<P>(a.boxes) + slot * box_vals;
    k3.nhi = rates.nhi = nhi;
    if (rc == 0) switch (mode) {
        case kSweepK1:
          rc = launch_sweep<T>(tb, pl, spec, nhi, cd, sc);
          break;
        case kSweepK2:
          rc = launch_init_segments<T>(nhi, cd, planes[0], spec.B, Dc, c,
                                       T(dr), st);
          for (int k = 0; k < s.seg_K && rc == 0; ++k) {
            const int r0 = 1 + k * s.seg_S;
            const int r1 = r0 + s.seg_S < R1 ? r0 + s.seg_S : R1;
            rc = launch_seg<T>(tb, pl, spec, nhi, planes[k & 1],
                               planes[(k + 1) & 1], r0, r1, cd, sc);
          }
          break;
        case kSweepK1f:
          rc = launch_gamma<T>(tb, pl, spec, nhi, rt_tab, flux_b, bins_s,
                               bins_w, s.E, T(s.R2), T(s.sdr3), phi, sc);
          break;
        default:
          k3.flux = flux_b;
          rc = launch_rates<T>(tb, pl, spec, k3);
      }
    if (rc == 0 && !whole) {
      rates.flux = flux_b;
      rc = launch_rates_dense<T>(rates, st);
    }
    if (rc == 0) rc = launch_accumulate<T>(acc, ac, rated, st);
    if (rc != 0) return rc;
  }
  return 0;
}

// The helium trace of nb batches (see HeLoopBufs, HeLoopArgs): per chunk of
// s.chunk batches one extract of the three species' boxes out of their
// frames, then per batch on its slot of the chunk three sweeps into the cd
// boxes, one per species at its threshold cross section (K1, or with
// s.seg_S the segmented sweep's start and K2 over seg_K segments), the
// three-species rate pass at the listed cells, and the accumulate of its
// 3-4 channels into the rate frames at rb0, over the listed cells. Three
// sweep tables, one plan and the pass's constants are made once; nothing
// synchronizes with the host. With spec.max_clusters only ask how many of
// the sweep's clusters fit.
template <typename T>
int he_trace_sweep(const HeLoopBufs& a, const HeLoopArgs& s, const void* sw,
                   const void* path, const void* diag, const void* mask_m,
                   const void* mask_p, int Dc, int c, int R1, double dr,
                   double sig, const LaunchSpec& spec) {
  const cudaStream_t st = static_cast<cudaStream_t>(spec.stream);
  if (!he_loop_fits<T>(a, s, spec.B, Dc, c, R1))
    return cudaErrorInvalidValue;
  const double sigs[kHeSpecies] = {sig, s.sig_he[0], s.sig_he[1]};
  Tables<T> tb[kHeSpecies];
  for (int sp = 0; sp < kHeSpecies; ++sp)
    tb[sp] = make_tables<T>(sw, path, diag, mask_m, mask_p, Dc, c, R1, dr,
                            sigs[sp]);
  Plan pl;
  const cudaError_t err = make_plan<T>(spec, Dc, 0, false, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool seg = s.seg_S > 0, heat = a.out[kHeSpecies] != nullptr;
  using P = const T*;
  T* const boxes = static_cast<T*>(a.boxes);
  T* const cd = static_cast<T*>(a.cd);
  T* const planes[2] = {static_cast<T*>(a.planes[0]),
                        static_cast<T*>(a.planes[1])};
  T* const sc = static_cast<T*>(a.scratch);
  if (spec.max_clusters != nullptr)
    return seg ? launch_seg<T>(tb[0], pl, spec, boxes, planes[0], planes[1],
                               1, 1, cd, sc)
               : launch_sweep<T>(tb[0], pl, spec, boxes, cd, sc);
  const size_t box_vals = size_t(spec.B) * Dc * Dc * Dc;
  const size_t chunk_vals = size_t(s.chunk) * box_vals;
  const size_t S3 = size_t(s.Ds) * s.Ds * s.Ds;
  const int n_out = heat ? kHeSpecies + 1 : kHeSpecies;
  HeRates<T> hr = he_rates_of<T>(a, s, spec.B, Dc);
  hr.dr = static_cast<T>(dr);
  void* src[kHeSpecies];
  void* slots[kHeSpecies];
  void* frames[kHeSpecies + 1];
  void* rate_boxes[kHeSpecies + 1];
  for (int sp = 0; sp < kHeSpecies; ++sp) {
    src[sp] = const_cast<void*>(a.frames[sp]);
    slots[sp] = boxes + sp * chunk_vals;
  }
  for (int ch = 0; ch < kHeSpecies + 1; ++ch) {
    frames[ch] = a.out[ch];
    rate_boxes[ch] = hr.out[ch];
  }
  const Channels<T> in = channels<T>(src, slots, kHeSpecies);
  const Channels<T> acc = channels<T>(frames, rate_boxes, n_out);
  Chunk chunk{a.pos, 0, s.chunk, spec.B, Dc, (long long)s.F1 * s.F2, s.F2};
  // the rate boxes are 0 outside the listed cells: the accumulate visits
  // those only
  const Visit<T> rated{a.cells, static_cast<P>(a.rt_sub) + 2 * S3,
                       s.n_valid};
  BoxSet ac{a.pos, 0, spec.B, s.Ds, s.rb0, s.F0, s.F1, s.F2};
  P fl = static_cast<P>(a.flux);
  for (int b = 0; b < s.nb; ++b) {
    ac.batch = b;
    const int slot = b % s.chunk;
    int rc = 0;
    if (slot == 0) {
      // the three species' boxes of batches b .. b + k - 1 in one launch
      chunk.k0 = b;
      chunk.k = s.nb - b < s.chunk ? s.nb - b : s.chunk;
      rc = launch_extract<T>(in, chunk, st);
    }
    for (int sp = 0; sp < kHeSpecies && rc == 0; ++sp) {
      // species sp's boxes of batch b: its slot of the chunk
      const T* n = boxes + sp * chunk_vals + slot * box_vals;
      T* out = cd + sp * box_vals;
      hr.n[sp] = n;
      if (!seg) {
        rc = launch_sweep<T>(tb[sp], pl, spec, n, out, sc);
        continue;
      }
      rc = launch_init_segments<T>(n, out, planes[0], spec.B, Dc, c, T(dr),
                                   st);
      for (int k = 0; k < s.seg_K && rc == 0; ++k) {
        const int r0 = 1 + k * s.seg_S;
        const int r1 = r0 + s.seg_S < R1 ? r0 + s.seg_S : R1;
        rc = launch_seg<T>(tb[sp], pl, spec, n, planes[k & 1],
                           planes[(k + 1) & 1], r0, r1, out, sc);
      }
    }
    if (rc == 0) {
      hr.flux = fl + size_t(b) * spec.B;
      rc = issue_rates_he<T>(hr, st);
    }
    if (rc == 0) rc = launch_accumulate<T>(acc, ac, rated, st);
    if (rc != 0) return rc;
  }
  return 0;
}

// The launches of the box engine's kernels (box_sweep.cuh) and its trace.

// The sweep's form: blocks of `threads` threads, the ring in shared memory
// (`shared`) or in global memory, at most `blocks` blocks a launch (fewer
// than the sources where the global rings' scratch bounds them: each block
// sweeps source after source in its own ring).
struct BoxSweepPlan {
  int threads, shared, blocks;
};

// How many of the sweep's blocks of form `p` (its blocks aside) the card
// holds at once.
template <typename T>
int box_resident(const box::Geom<T>& g, const BoxSweepPlan& p, int* held) {
  return p.shared ? box::sweep_resident<T, true>(g, p.threads, held)
                  : box::sweep_resident<T, false>(g, p.threads, held);
}

template <typename T>
int launch_box_gather(const box::Geom<T>& g, const T* frame, const int* pos,
                      T* out, int n, cudaStream_t st) {
  const dim3 grid((g.n_v + box::kThreads - 1) / box::kThreads, n);
  box::sheet_gather_kernel<T><<<grid, box::kThreads, 0, st>>>(g, frame, pos,
                                                              out);
  return static_cast<int>(cudaGetLastError());
}

// The sweep of io.n sources in form `p` (at most as many blocks as
// sources).
template <typename T>
int launch_box_sweep(const box::Geom<T>& g, const box::SweepIO<T>& io,
                     const BoxSweepPlan& p, cudaStream_t st) {
  const int blocks = p.blocks < io.n ? p.blocks : io.n;
  return p.shared ? box::launch_sweep<T, true>(g, io, p.threads, blocks, st)
                  : box::launch_sweep<T, false>(g, io, p.threads, blocks, st);
}

// The pointers of a box trace of nb batches of B sources.
template <typename T>
struct BoxTrace {
  const T* frame;       // (P, P, P) the padded nHI frame
  const int* pos;       // (nb, B, 3) box corners in the frame
  const T* flux;        // (nb, B)
  const T* sdr3;        // S* / dr^3, on the device
  T* nhi;               // (dev_batch, n_v) scratch: the gathered nHI
  T* cdin;              // (dev_batch, n_v) scratch: incoming column
                        // densities
  T* ring;              // the sweep's rings in global memory (its plan's
                        // blocks), null in the shared placement
  T* phi;               // (chunk B, Dc^3) scratch: a chunk's rate boxes
  T* heat;              // (chunk B, Dc^3), null without the heat channel
  T* phi_frame;         // (P, P, P) accumulated into, zeroed by the caller
  T* heat_frame;        // null without the heat channel
};

// The trace of nb batches of B sources, dev_batch sources (a multiple of
// B) a device batch: the rate boxes of a chunk of `chunk` batches zeroed
// once (the rate pass writes only the rated cells), then per device batch
// the gather and the sweep (form `p`), per chunk of batches one rate pass
// into the chunk's boxes, and per batch of B the accumulate of its boxes
// over the rated cells, batch after batch, so every frame cell takes its
// adds in source order as the plain loop gives them. `bins`: the tables'
// bins (3 E doubles) for the rate pass's parameters. Each launch that is
// issued adds one to its kernel's entry of `launches` (the gather, the
// sweep, the rate pass, the accumulate). On `st`; returns the first error;
// a refused launch never runs.
template <typename T>
int box_trace(const box::Geom<T>& g, const BoxTrace<T>& tr,
              const double* bins, int nb, int B, int dev_batch, int chunk,
              const BoxSweepPlan& p, int* launches, cudaStream_t st) {
  if (nb < 0 || B < 1 || dev_batch < B || dev_batch % B != 0 || chunk < 1 ||
      !box::fits(g, dev_batch, tr.heat != nullptr) ||
      !box::rates_fit(g, chunk * B) ||
      (tr.heat == nullptr) != (tr.heat_frame == nullptr))
    return cudaErrorInvalidValue;
  const size_t D3 = size_t(g.Dc) * g.Dc * g.Dc;
  const size_t box_bytes = size_t(chunk) * B * D3 * sizeof(T);
  cudaError_t err = cudaMemsetAsync(tr.phi, 0, box_bytes, st);
  if (err == cudaSuccess && tr.heat)
    err = cudaMemsetAsync(tr.heat, 0, box_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const box::Bins<T> bp = box::make_bins<T>(bins, g.E);
  void* frames[2] = {tr.phi_frame, tr.heat_frame};
  const Visit<T> rated{g.rcell, g.visit, g.n_r};
  const int ns = nb * B;
  for (int s = 0; s < ns; s += dev_batch) {
    const int n = min(dev_batch, ns - s);
    int rc = launch_box_gather<T>(g, tr.frame, tr.pos + size_t(3) * s,
                                  tr.nhi, n, st);
    launches[0] += rc == 0;
    if (rc == 0) {
      rc = launch_box_sweep<T>(g, box::SweepIO<T>{tr.nhi, tr.cdin, tr.ring, n},
                               p, st);
      launches[1] += rc == 0;
    }
    for (int a = 0; rc == 0 && a < n; a += chunk * B) {
      const int m = min(chunk * B, n - a);
      const size_t at = size_t(a) * g.n_v;
      const box::RateIO<T> io{tr.nhi + at, tr.cdin + at, tr.flux + s + a,
                              tr.sdr3, tr.phi, tr.heat};
      rc = box::launch_rates<T>(g, io, bp, m, st);
      launches[2] += rc == 0;
      for (int j = 0; rc == 0 && j < m / B; ++j) {
        void* boxes[2] = {tr.phi + size_t(j) * B * D3,
                          tr.heat ? tr.heat + size_t(j) * B * D3 : nullptr};
        rc = launch_accumulate<T>(
            channels<T>(frames, boxes, tr.heat ? 2 : 1),
            BoxSet{tr.pos, (s + a) / B + j, B, g.Dc, 0, g.P, g.P, g.P}, rated,
            st);
        launches[3] += rc == 0;
      }
    }
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// Accumulate the boxes of batch `batch` of the n channels boxes[c] into
// frames[c] on `stream`, at the n_cells rated cells `cells` of every box
// (where `valid`, the rates table's valid channel, exceeds 0.5; the boxes 0
// elsewhere) where `cells` is set; returns the first cudaError_t that is
// not cudaSuccess.
#define ACCUMULATE_ENTRY(NAME, TYPE)                                           \
  int NAME(void* const* frames, void* const* boxes, int n, const int* pos,   \
           int batch, int B, int D, int shift, int F0, int F1, int F2,         \
           const int* cells, const void* valid, int n_cells, void* stream) {   \
    return launch_accumulate<TYPE>(                                            \
        channels<TYPE>(frames, boxes, n),                                      \
        BoxSet{pos, batch, B, D, shift, F0, F1, F2},                           \
        Visit<TYPE>{cells, static_cast<const TYPE*>(valid), n_cells},          \
        static_cast<cudaStream_t>(stream));                                    \
  }

ACCUMULATE_ENTRY(accumulate_boxes_f32, float)
ACCUMULATE_ENTRY(accumulate_boxes_f64, double)

// The (k, B, D, D, D) boxes of batches k0 .. k0 + k - 1 of the n channels
// frames[c] (strides S0, S1, 1) into boxes[c] on `stream`, one launch;
// returns the first cudaError_t that is not cudaSuccess.
#define EXTRACT_ENTRY(NAME, TYPE)                                              \
  int NAME(void* const* frames, void* const* boxes, int n, const int* pos,   \
           int k0, int k, int B, int D, long long S0, long long S1,           \
           void* stream) {                                                    \
    return launch_extract<TYPE>(channels<TYPE>(frames, boxes, n),              \
                                Chunk{pos, k0, k, B, D, S0, S1},               \
                                static_cast<cudaStream_t>(stream));            \
  }

EXTRACT_ENTRY(extract_chunk_f32, float)
EXTRACT_ENTRY(extract_chunk_f64, double)

// The trace of nb batches in the sweep mode `mode` (0: K1 + the rate pass,
// 1: K2 over seg_K segments of seg_S shells + the rate pass, 2: K1f, 3: K3,
// K3h with the heat channel; see trace_sweep above) on `stream`, with the
// sweep's launch arguments and plan as its entry points take them. Returns
// the first cudaError_t that is not cudaSuccess; with `max_clusters` set it
// launches nothing and writes there how many of the sweep's clusters are
// resident at once.
#define CHEB_TRACE_SWEEP_ENTRY(NAME, TYPE)                                     \
  int NAME(const void* frame, const int* pos, const void* flux,               \
           const void* sw, const void* path, const void* diag,                \
           const void* mask_m, const void* mask_p, const void* rt_tab,        \
           const void* rt_sub, const int* cells, const void* bins_s,          \
           const void* bins_w, const void* bins_wh, void* phi_frame,          \
           void* heat_frame,                                                  \
           void* boxes, void* work0, void* work1, void* phi, void* heat,      \
           void* planes0, void* planes1, void* scratch, int mode,             \
           int E, double R2, double sdr3, double s_fac, int threads_b,        \
           int rb0, int Ds, int n_valid, int seg_S, int seg_K, int F0,        \
           int F1, int F2, int nb, int chunk,                                 \
           int B, int Dc, int c, int R1, double dr, double sig, int threads,   \
           int cluster, int shared_planes, int smem, int rate_threads,        \
           int ring, int* max_clusters, void* stream) {                       \
    return trace_sweep<TYPE>(                                                  \
        SweepLoopBufs{frame, pos, flux, rt_tab, rt_sub, cells, bins_s, bins_w, \
                      bins_wh, phi_frame, heat_frame, boxes, {work0, work1},   \
                      phi, heat, {planes0, planes1}, scratch},                 \
        SweepLoopArgs{nb, mode, E, R2, sdr3, s_fac, threads_b, rb0, Ds,        \
                      n_valid, seg_S, seg_K, F0, F1, F2, chunk},               \
        sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig,                    \
        LaunchSpec{B, threads, cluster, shared_planes, smem, rate_threads,     \
                   ring, max_clusters, stream});                               \
  }

CHEB_TRACE_SWEEP_ENTRY(cheb_trace_sweep_f32, float)
CHEB_TRACE_SWEEP_ENTRY(cheb_trace_sweep_f64, double)

// The helium trace of nb batches (see he_trace_sweep above) on `stream`: the
// three species' frames frame0..frame2 (n_HI, n_HeI, n_HeII) in, the rate
// frames out0..out2 (and, where out3 is set, the heat frame out3) out,
// with the sweep's launch arguments and plan as its entry points take them
// (sig: sigma_HI; sig_he1, sig_he2: the other two sweeps'). Returns the
// first cudaError_t that is not cudaSuccess; with `max_clusters` set it
// launches nothing and writes there how many of the sweep's clusters are
// resident at once.
#define HE_TRACE_SWEEP_ENTRY(NAME, TYPE)                                       \
  int NAME(const void* frame0, const void* frame1, const void* frame2,        \
           const int* pos, const void* flux, const void* sw,                  \
           const void* path, const void* diag, const void* mask_m,            \
           const void* mask_p, const void* rt_sub, const int* cells,          \
           const void* rec, const int* bands, void* out0, void* out1,         \
           void* out2, void* out3, void* boxes, void* cd, void* rates,        \
           void* planes0, void* planes1, void* scratch, double sdr3,          \
           double sig_he1, double sig_he2, int rb0, int Ds, int n_valid,      \
           int seg_S, int seg_K, int F0, int F1, int F2, int nb, int chunk,   \
           int B, int Dc, int c, int R1, double dr, double sig,    \
           int threads, int cluster, int shared_planes, int smem,             \
           int rate_threads, int ring, int* max_clusters, void* stream) {     \
    return he_trace_sweep<TYPE>(                                               \
        HeLoopBufs{{frame0, frame1, frame2}, pos, flux, rt_sub, cells, rec,    \
                   bands, {out0, out1, out2, out3}, boxes, cd, rates,          \
                   {planes0, planes1}, scratch},                               \
        HeLoopArgs{nb, sdr3, {sig_he1, sig_he2}, rb0, Ds, n_valid, seg_S,      \
                   seg_K, F0, F1, F2, chunk},                                  \
        sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig,                    \
        LaunchSpec{B, threads, cluster, shared_planes, smem, rate_threads,     \
                   ring, max_clusters, stream});                               \
  }

HE_TRACE_SWEEP_ENTRY(he_trace_sweep_f32, float)
HE_TRACE_SWEEP_ENTRY(he_trace_sweep_f64, double)

// The box engine's entry points take its tables as `tabs` (box::kTabs
// pointers), `dims` (box::kDims ints) and `vals` (dr, sig) in make_geom's
// order, and return the first cudaError_t that is not cudaSuccess (an
// invalid size is cudaErrorInvalidValue, nothing launched).
//
// box_resident: how many of the sweep's blocks of `threads` threads, the
// ring in shared memory (`shared`) or in global memory, the card holds at
// once, into `held`.
// box_gather: nHI at the valid sheet cells of the n sources whose boxes
// start at pos (n, 3), int32, in the padded frame (P^3) into out (n, n_v).
// box_sweep: from nhi (n, n_v) the incoming column densities cdin (n,
// n_v), a source a block of `threads` threads, at most `blocks` blocks, the
// ring in shared memory (`shared`) or in `ring` (the blocks' rings,
// box::ring_bytes each).
// box_rates: the rate pass of n sources from nhi and cdin (n, n_v), the
// fluxes flux (n,) and S* / dr^3 at sdr3 (on the device), the tables' bins
// (3 E doubles on the host), into the rated cells of the rate boxes phi
// (and heat, where it is set) (n, Dc^3); their other cells are left as they
// are.
// box_trace_sweep: the trace of nb batches of B sources (pos (nb, B, 3),
// flux (nb, B)) over the padded frame, dev_batch sources a device batch,
// with nhi and cdin (dev_batch, n_v), the sweep's rings and phi and heat
// (chunk B, Dc^3) as scratch, into phi_frame (and heat_frame), zeroed by the
// caller; the sweep as box_sweep's, a rate pass a chunk of `chunk` batches;
// each launch it issues adds one to launches[4] (the gather, the sweep, the
// rate pass, the accumulate).
#define BOX_ENTRIES(SFX, TYPE)                                                 \
  int box_resident_##SFX(void* const* tabs, const int* dims,                   \
                         const double* vals, int threads, int shared,          \
                         int* held) {                                          \
    const box::Geom<TYPE> g = box::make_geom<TYPE>(tabs, dims, vals);          \
    if (!box::fits(g, 1, false)) return cudaErrorInvalidValue;                 \
    return box_resident<TYPE>(g, BoxSweepPlan{threads, shared, 1}, held);      \
  }                                                                            \
  int box_gather_##SFX(void* const* tabs, const int* dims,                     \
                       const double* vals, const void* frame, const int* pos,  \
                       void* out, int n, void* stream) {                       \
    const box::Geom<TYPE> g = box::make_geom<TYPE>(tabs, dims, vals);          \
    if (!box::fits(g, n, false)) return cudaErrorInvalidValue;                 \
    return launch_box_gather<TYPE>(g, static_cast<const TYPE*>(frame), pos,    \
                                   static_cast<TYPE*>(out), n,                 \
                                   static_cast<cudaStream_t>(stream));         \
  }                                                                            \
  int box_sweep_##SFX(void* const* tabs, const int* dims, const double* vals,  \
                      const void* nhi, void* cdin, void* ring, int n,          \
                      int threads, int shared, int blocks, void* stream) {     \
    const box::Geom<TYPE> g = box::make_geom<TYPE>(tabs, dims, vals);          \
    if (!box::fits(g, n, false)) return cudaErrorInvalidValue;                 \
    return launch_box_sweep<TYPE>(                                             \
        g,                                                                     \
        box::SweepIO<TYPE>{static_cast<const TYPE*>(nhi),                      \
                           static_cast<TYPE*>(cdin), static_cast<TYPE*>(ring), \
                           n},                                                 \
        BoxSweepPlan{threads, shared, blocks},                                 \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int box_rates_##SFX(void* const* tabs, const int* dims, const double* vals,  \
                      const double* bins, const void* nhi, const void* cdin,   \
                      const void* flux, const void* sdr3, void* phi,           \
                      void* heat, int n, void* stream) {                       \
    const box::Geom<TYPE> g = box::make_geom<TYPE>(tabs, dims, vals);          \
    if (!box::fits(g, n, heat != nullptr)) return cudaErrorInvalidValue;       \
    using P = const TYPE*;                                                     \
    const box::RateIO<TYPE> a{static_cast<P>(nhi), static_cast<P>(cdin),       \
                              static_cast<P>(flux), static_cast<P>(sdr3),      \
                              static_cast<TYPE*>(phi),                         \
                              static_cast<TYPE*>(heat)};                       \
    return box::launch_rates<TYPE>(g, a, box::make_bins<TYPE>(bins, g.E), n,   \
                                   static_cast<cudaStream_t>(stream));         \
  }                                                                            \
  int box_trace_sweep_##SFX(                                                   \
      void* const* tabs, const int* dims, const double* vals,                  \
      const double* bins, const void* frame, const int* pos, const void* flux, \
      const void* sdr3, void* nhi, void* cdin, void* ring, void* phi,          \
      void* heat, void* phi_frame, void* heat_frame, int nb, int B,            \
      int dev_batch, int chunk, int threads, int shared, int blocks,           \
      int* launches, void* stream) {                                           \
    const box::Geom<TYPE> g = box::make_geom<TYPE>(tabs, dims, vals);          \
    using P = const TYPE*;                                                     \
    const BoxTrace<TYPE> tr{static_cast<P>(frame), pos, static_cast<P>(flux),  \
                            static_cast<P>(sdr3), static_cast<TYPE*>(nhi),     \
                            static_cast<TYPE*>(cdin), static_cast<TYPE*>(ring),\
                            static_cast<TYPE*>(phi), static_cast<TYPE*>(heat), \
                            static_cast<TYPE*>(phi_frame),                     \
                            static_cast<TYPE*>(heat_frame)};                   \
    return box_trace<TYPE>(g, tr, bins, nb, B, dev_batch, chunk,               \
                           BoxSweepPlan{threads, shared, blocks},              \
                           launches, static_cast<cudaStream_t>(stream));       \
  }

BOX_ENTRIES(f32, float)
BOX_ENTRIES(f64, double)

const char* trace_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
