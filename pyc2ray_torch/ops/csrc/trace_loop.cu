// The batch loop of a Chebyshev-face trace on NVIDIA Hopper (sm_90a): the
// box extract, the ordered accumulate, and the loop that issues a whole
// fuse_fold trace (K3 / K3h) from the host side of the library.
//
// Counterpart of the JAX engine's compiled trace (pyc2ray_tpu/ops/
// raytrace_cheb.py: _trace_jit, the lax.scan over batches with
// _extract_boxes, _sweep_fold_rates and the per-source
// dynamic_update_slice accumulate), which XLA runs on the device with one
// host call per trace. No TPU kernel of its own: the extract and the
// accumulate are XLA's there; here they are the port's own kernels. Plain
// versions: pyc2ray_torch/ops/trace_loop.py::extract_boxes_ref and
// add_boxes; of the loop, trace_loop.py::cheb_trace_rates_ref.
//
//   extract_boxes_kernel     the (B, D, D, D) boxes of the extended frame
//                            at a batch's box corners, for up to
//                            kMaxChannels frames at once.
//   accumulate_boxes_kernel  adds a batch's B boxes of side D into the
//                            frame at corner + shift, source by source in
//                            batch order, for up to kMaxChannels frames.
//   trace_rates              per batch: extract -> K3 phase A -> phase B ->
//                            accumulate, all on one stream, nothing
//                            synchronizing with the host.
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

// The fuse_fold trace of nb batches: per batch the nHI boxes out of
// `frame`, K3 (K3h with `heat_frame`) into the rate boxes, and their
// accumulate into `phi_frame` (and `heat_frame`), which the caller zeroed.
// The tables and the plan are made once. With spec.max_clusters only ask
// how many of phase A's clusters fit.
template <typename T>
int trace_rates(const void* frame, const int* pos, const void* flux, int nb,
                const void* sw, const void* path, const void* diag,
                const void* mask_m, const void* mask_p, const void* rt,
                const void* bins_s, const void* bins_w, const void* bins_wh,
                void* phi_frame, void* heat_frame, void* boxes, void* phi,
                void* heat, void* ci, void* dc, void* scratch, int E,
                double s_fac, double sdr3, int threads_b, int F0, int F1,
                int F2, int Dc, int c, int R1, double dr, double sig,
                const LaunchSpec& spec) {
  const cudaStream_t st = static_cast<cudaStream_t>(spec.stream);
  const Tables<T> tb = make_tables<T>(sw, path, diag, mask_m, mask_p, Dc, c,
                                      R1, dr, sig);
  Plan pl;
  const cudaError_t err = make_plan<T>(spec, Dc, 0, false, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool with_heat = heat_frame != nullptr;
  if ((heat != nullptr) != with_heat || (bins_wh != nullptr) != with_heat)
    return cudaErrorInvalidValue;
  RatesCall<T> k{static_cast<const T*>(boxes), static_cast<const T*>(rt),
                 static_cast<const T*>(bins_s), static_cast<const T*>(bins_w),
                 static_cast<const T*>(bins_wh), static_cast<const T*>(flux),
                 static_cast<T*>(phi), static_cast<T*>(heat),
                 static_cast<T*>(ci), static_cast<T*>(dc),
                 static_cast<T*>(scratch), E, threads_b,
                 static_cast<T>(s_fac), static_cast<T>(sdr3)};
  if (spec.max_clusters != nullptr) return launch_rates<T>(tb, pl, spec, k);
  void* src[1] = {const_cast<void*>(frame)};
  void* nhi_box[1] = {boxes};
  void* frames[2] = {phi_frame, heat_frame};
  void* rates[2] = {phi, heat};
  const Channels<T> in = channels<T>(src, nhi_box, 1);
  const Channels<T> out = channels<T>(frames, rates, with_heat ? 2 : 1);
  BoxSet bs{pos, 0, spec.B, Dc, 0, F0, F1, F2};
  for (int b = 0; b < nb; ++b) {
    bs.batch = b;
    k.flux = static_cast<const T*>(flux) + size_t(b) * spec.B;
    int rc = launch_boxes<T>(true, in, bs, st);
    if (rc == 0) rc = launch_rates<T>(tb, pl, spec, k);
    if (rc == 0) rc = launch_boxes<T>(false, out, bs, st);
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

// The fuse_fold trace of nb batches (trace_rates above), on `stream`, with
// K3's launch arguments and plan as cheb_sweep_rates_* takes them. Returns
// the first cudaError_t that is not cudaSuccess; with `max_clusters` set it
// launches nothing and writes there how many of phase A's clusters are
// resident at once.
#define CHEB_TRACE_RATES_ENTRY(NAME, TYPE)                                     \
  int NAME(const void* frame, const int* pos, const void* flux,               \
           const void* sw, const void* path, const void* diag,                \
           const void* mask_m, const void* mask_p, const void* rt,            \
           const void* bins_s, const void* bins_w, const void* bins_wh,       \
           void* phi_frame, void* heat_frame, void* boxes, void* phi,         \
           void* heat, void* ci, void* dc, void* scratch, int E,              \
           double s_fac, double sdr3, int threads_b, int F0, int F1, int F2,  \
           int nb, int B, int Dc, int c, int R1, double dr, double sig,       \
           int threads, int cluster, int shared_planes, int smem,             \
           int rate_threads, int ring, int* max_clusters, void* stream) {     \
    return trace_rates<TYPE>(                                                  \
        frame, pos, flux, nb, sw, path, diag, mask_m, mask_p, rt, bins_s,      \
        bins_w, bins_wh, phi_frame, heat_frame, boxes, phi, heat, ci, dc,      \
        scratch, E, s_fac, sdr3, threads_b, F0, F1, F2, Dc, c, R1, dr, sig,    \
        LaunchSpec{B, threads, cluster, shared_planes, smem, rate_threads,     \
                   ring, max_clusters, stream});                               \
  }

CHEB_TRACE_RATES_ENTRY(cheb_trace_rates_f32, float)
CHEB_TRACE_RATES_ENTRY(cheb_trace_rates_f64, double)

const char* trace_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
