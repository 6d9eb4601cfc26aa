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
// extract_boxes_ref and add_boxes; of the loop, trace_loop.py::
// cheb_trace_sweep_ref.
//
//   extract_boxes_kernel     the (B, D, D, D) boxes of the extended frame
//                            at a batch's box corners, for up to
//                            kMaxChannels frames at once.
//   accumulate_boxes_kernel  adds a batch's B boxes of side D into the
//                            frame at corner + shift, source by source in
//                            batch order, for up to kMaxChannels frames.
//   trace_sweep              per batch, all on one stream, nothing
//                            synchronizing with the host: extract -> K1 ->
//                            the dense rate pass (cheb_rates.cuh) ->
//                            accumulate at shift rb0 (the default mode,
//                            with do_heating the heat beside Gamma); extract
//                            -> the segmented sweep's start -> K2 x seg_K ->
//                            the rate pass -> accumulate (shell_segment);
//                            extract -> K1f -> accumulate (fuse_rates);
//                            extract -> K3 phase A -> phase B -> accumulate
//                            (fuse_fold, K3h with do_heating).
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
// float32 and float64. A thread tests at most B boxes per channel for
// coverage.
//
// Bound. Both kernels move bytes and do next to no arithmetic: the extract
// reads B D^3 values of the frame and writes the boxes; the accumulate reads
// the boxes and reads and writes the union of their cells in the frame (B D^3
// when no two boxes overlap). At the EoR run's shape (B = 16, D = 24,
// float32) that is 1.8 MB and 2.7 MB: 0.53 and 0.79 us at 3.35 TB/s, far
// below a launch's own cost, so the kernels are plain grid-stride loops, one
// block per box plane, with nothing staged in shared memory; the index
// arithmetic within a plane is 32-bit (a 64-bit division per cell would
// cost more than the cell's bytes).

#include "cheb_rates.cuh"
#include "cheb_sweep_kernels.cuh"
#include "cheb_sweep_rates.cuh"

namespace {

using namespace cheb;

constexpr int kMaxChannels = 4;   // frames moved by one launch
constexpr int kBoxThreads = 256;  // threads per block of the two kernels

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

// Block (b, i) copies plane i of box b of every channel.
template <typename T>
__global__ void extract_boxes_kernel(Channels<T> ch, BoxSet bs) {
  const int D = bs.D, b = blockIdx.x / D, i = blockIdx.x % D;
  const int* p = bs.corners() + 3 * b;
  const unsigned D2 = unsigned(D) * D;
  const size_t out = (size_t(b) * D + i) * D2;
  for (unsigned jk = threadIdx.x; jk < D2; jk += blockDim.x) {
    const int j = int(jk / unsigned(D)), k = int(jk) - j * D;
    const size_t src = bs.at(p[0] + i, p[1] + j, p[2] + k);
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      if (c < ch.n) ch.box[c][out + jk] = ch.frame[c][src];
  }
}

// Block (b, i) visits plane i of box b; a thread owns its frame cell when no
// box before b covers it, and then adds every covering box's value into it
// in ascending box index (see the head of this file).
template <typename T>
__global__ void accumulate_boxes_kernel(Channels<T> ch, BoxSet bs) {
  const int D = bs.D, b = blockIdx.x / D, i = blockIdx.x % D;
  const int* P = bs.corners();
  const unsigned D2 = unsigned(D) * D;
  const size_t D3 = size_t(D2) * D;
  const int x = P[3 * b] + i;
  for (unsigned jk = threadIdx.x; jk < D2; jk += blockDim.x) {
    const int j = int(jk / unsigned(D));
    const int y = P[3 * b + 1] + j, z = P[3 * b + 2] + int(jk) - j * D;
    bool owner = true;
    for (int o = 0; o < b && owner; ++o)
      owner = !covers(P + 3 * o, x, y, z, D);
    if (!owner) continue;
    const size_t t = bs.at(x, y, z);
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c >= ch.n) break;
      T v = ch.frame[c][t];
      for (int o = b; o < bs.B; ++o) {
        const int* q = P + 3 * o;
        if (covers(q, x, y, z, D))
          v = Arith<T>::add(
              v, ch.box[c][o * D3 + (size_t(x - q[0]) * D + (y - q[1])) * D +
                           (z - q[2])]);
      }
      ch.frame[c][t] = v;
    }
  }
}

// The launches of the two kernels and of the trace loop.

template <typename T>
int launch_boxes(bool extract, const Channels<T>& ch, const BoxSet& bs,
                 cudaStream_t st) {
  if (ch.n < 1 || ch.n > kMaxChannels) return cudaErrorInvalidValue;
  if (extract)
    extract_boxes_kernel<T><<<bs.B * bs.D, kBoxThreads, 0, st>>>(ch, bs);
  else
    accumulate_boxes_kernel<T><<<bs.B * bs.D, kBoxThreads, 0, st>>>(ch, bs);
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
  const void* bins_s;
  const void* bins_w;
  const void* bins_wh;    // null without the heat channel
  void* phi_frame;        // zeroed by the caller
  void* heat_frame;       // null without the heat channel
  void* boxes;            // (B, Dc, Dc, Dc) scratch: the nHI boxes
  void* work[2];          // (B, Dc, Dc, Dc) scratch each: the sweep's box
                          // (K1, K2) in work[0]; K3's cdin and dcol boxes
  void* phi;              // (B, Ds^3) rate boxes, (B, Dc^3) with K1f, K3
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
  int rb0, Ds;            // the rate pass's subbox
  int seg_S, seg_K;       // K2: shells per segment, segments
  int F0, F1, F2;         // the frame's extents
};

// The trace of nb batches in sweep mode `mode` (see SweepMode): per batch
// the nHI boxes out of the frame, the mode's sweep and rates, and the
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
      (mode == kSweepK3 && !a.work[1]))
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
  DenseRates<T> rates{cd, nhi, static_cast<P>(a.rt_sub), fl, bins_s, bins_w,
                      static_cast<P>(a.bins_wh), phi, static_cast<T*>(a.heat),
                      spec.B, s.E, Dc, s.Ds, s.rb0, static_cast<T>(dr),
                      static_cast<T>(sig), static_cast<T>(s.sdr3)};
  void* src[1] = {const_cast<void*>(a.frame)};
  void* nhi_box[1] = {a.boxes};
  void* frames[2] = {a.phi_frame, a.heat_frame};
  void* out[2] = {a.phi, a.heat};
  const Channels<T> in = channels<T>(src, nhi_box, 1);
  const Channels<T> acc = channels<T>(frames, out, with_heat ? 2 : 1);
  BoxSet ex{a.pos, 0, spec.B, Dc, 0, s.F0, s.F1, s.F2};
  BoxSet ac{a.pos, 0, spec.B, whole ? Dc : s.Ds, whole ? 0 : s.rb0,
            s.F0, s.F1, s.F2};
  for (int b = 0; b < s.nb; ++b) {
    ex.batch = ac.batch = b;
    const T* flux_b = fl + size_t(b) * spec.B;
    int rc = launch_boxes<T>(true, in, ex, st);
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
    if (rc == 0) rc = launch_boxes<T>(false, acc, ac, st);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// Extract (`extract` = 1) or accumulate (0) the boxes of batch `batch` for
// the n channels frames[c] <-> boxes[c] on `stream`; returns the first
// cudaError_t that is not cudaSuccess.
#define BOXES_ENTRY(NAME, TYPE)                                                \
  int NAME(int extract, void* const* frames, void* const* boxes, int n,        \
           const int* pos, int batch, int B, int D, int shift, int F0, int F1, \
           int F2, void* stream) {                                            \
    return launch_boxes<TYPE>(extract != 0, channels<TYPE>(frames, boxes, n),  \
                              BoxSet{pos, batch, B, D, shift, F0, F1, F2},     \
                              static_cast<cudaStream_t>(stream));              \
  }

BOXES_ENTRY(boxes_f32, float)
BOXES_ENTRY(boxes_f64, double)

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
           const void* rt_sub, const void* bins_s, const void* bins_w,        \
           const void* bins_wh, void* phi_frame, void* heat_frame,            \
           void* boxes, void* work0, void* work1, void* phi, void* heat,      \
           void* planes0, void* planes1, void* scratch, int mode, int E,      \
           double R2, double sdr3, double s_fac, int threads_b, int rb0,      \
           int Ds, int seg_S, int seg_K, int F0, int F1, int F2, int nb,      \
           int B, int Dc, int c, int R1, double dr, double sig, int threads,   \
           int cluster, int shared_planes, int smem, int rate_threads,        \
           int ring, int* max_clusters, void* stream) {                       \
    return trace_sweep<TYPE>(                                                  \
        SweepLoopBufs{frame, pos, flux, rt_tab, rt_sub, bins_s, bins_w,        \
                      bins_wh, phi_frame, heat_frame, boxes, {work0, work1},   \
                      phi, heat, {planes0, planes1}, scratch},                 \
        SweepLoopArgs{nb, mode, E, R2, sdr3, s_fac, threads_b, rb0, Ds, seg_S, \
                      seg_K, F0, F1, F2},                                      \
        sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig,                    \
        LaunchSpec{B, threads, cluster, shared_planes, smem, rate_threads,     \
                   ring, max_clusters, stream});                               \
  }

CHEB_TRACE_SWEEP_ENTRY(cheb_trace_sweep_f32, float)
CHEB_TRACE_SWEEP_ENTRY(cheb_trace_sweep_f64, double)

const char* trace_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
