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
//      (_kernel's fused rate pass, fuse_rates=True). It writes, in place
//      of the cd, the flux-less Gamma of every valid face cell
//        S*/(dr^3 4 pi d2 path max(nHI, tiny)) sum_e w_e e^{-tau_in s_e}
//        (-expm1(-dtau s_e)),  masked by d2 <= R^2 and cdin <= 2e30,
//      with d2 the cell's true squared distance (the dist2 channel of the
//      rates table at its cartesian position) and the source cell 0. The
//      planes still carry the cd. Two faults of the TPU kernel are not
//      copied: it divides by nHI without a floor (0/0 at a zero-density
//      cell), and its d2 comes from the plane min(c+r, Dc-1) for both
//      signs, which is wrong for the minus face of a clipped box.
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
// precedence of the reference written as an if-chain. One block per source
// (the two signs of a face are coupled by the stitches, so they share a
// block); the block's threads sweep the 2*Dc*Dc cells of one face pair,
// then __syncthreads() before the next sub-step, which reads them. The
// planes of shells r-1 and r live in a per-block global scratch (12
// planes, 196 KB in f32 at Dc = 64), small enough to stay in the 50 MB L2.
// K1f keeps the spectral bins in shared memory, loaded once per block.
//
// Bound. Each reads the nHI box and the geometry tables once and writes
// one box: at B = 8, Dc = 64, R1 = 31 in f32, 8 MB + 10 MB + 8 MB, about
// 8 us at 3.35 TB/s. K1's arithmetic (~27 flops per face cell) is below
// that; K1f adds 2 transcendentals and ~5 flops per bin and valid cell,
// which bounds it by operations at 14 bins. The kernels are far from the
// bound: 3 (R1 - 1) dependent sub-steps run on only B blocks of 132 SMs,
// and each sub-step is L2-latency-bound. Shared-memory planes and several
// blocks per source are the next steps.

#include "cheb_sweep.cuh"

namespace {

using namespace cheb;

// K1 and K2: keep the cd of a valid face cell.
template <typename T>
struct StoreCd {
  T* box;
  __device__ void operator()(const FaceCell<T>& f) const { box[f.o] = f.out; }
};

// K1f: keep the flux-less Gamma of a valid face cell.
template <typename T>
struct StoreGamma {
  T* box;
  const T* rt;          // (Dc, 2, Dc, Dc): dist2, valid
  const T* bins;        // shared memory: s[E], w[E]
  int E, Dc;
  T R2, sdr3;           // R^2; S* / dr^3
  T sig;
  __device__ void operator()(const FaceCell<T>& f) const {
    using A = Arith<T>;
    const size_t D2 = size_t(Dc) * Dc;
    const T d2 = rt[f.o + (f.o / D2) * D2];            // channel 0 of plane i
    T g = T(0);
    if (d2 <= R2 && f.cdin <= T(kMaxColdensH)) {
      const T acc = bin_sum(A::mul(f.cdin, sig), A::mul(f.dcol, sig), bins, E);
      const T pref = A::div(sdr3, A::mul(A::mul(d2, f.path), T(kFourPi)));
      g = A::div(A::mul(pref, acc), max_lim(Arith<T>::tiny, f.nhi));
    }
    box[f.o] = g;
  }
};

template <typename T>
__global__ void cheb_sweep_kernel(Tables<T> tb, const T* __restrict__ nhi_all,
                                  T* box_all, T* scratch_all) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc, D3 = D2 * tb.Dc;
  const T* nhi = nhi_all + blockIdx.x * D3;
  T* box = box_all + blockIdx.x * D3;
  T* sc = scratch_all + blockIdx.x * 12 * D2;
  const T src_cd = source_cd(tb, nhi);
  fill_zero(box, D3);
  init_planes(tb, sc, src_cd);
  sweep_shells(tb, nhi, sc, 1, tb.R1, StoreCd<T>{box});
  if (threadIdx.x == 0) box[(size_t(tb.c) * tb.Dc + tb.c) * tb.Dc + tb.c] = src_cd;
}

template <typename T>
__global__ void cheb_sweep_gamma_kernel(Tables<T> tb, const T* __restrict__ nhi_all,
                                        const T* __restrict__ rt,
                                        const T* __restrict__ bins_s,
                                        const T* __restrict__ bins_w, int E,
                                        T R2, T sdr3, T* box_all, T* scratch_all) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc, D3 = D2 * tb.Dc;
  const T* nhi = nhi_all + blockIdx.x * D3;
  T* box = box_all + blockIdx.x * D3;
  T* sc = scratch_all + blockIdx.x * 12 * D2;
  T* bins = shared_bins<T>();
  load_bins(bins_s, bins_w, E, bins);
  fill_zero(box, D3);                 // the source cell stays 0
  init_planes(tb, sc, source_cd(tb, nhi));
  sweep_shells(tb, nhi, sc, 1, tb.R1,
               StoreGamma<T>{box, rt, bins, E, tb.Dc, R2, sdr3, tb.sig});
}

template <typename T>
__global__ void cheb_sweep_seg_kernel(Tables<T> tb, const T* __restrict__ nhi_all,
                                      const T* __restrict__ planes_in,
                                      T* planes_out, int r0, int r1,
                                      T* box_all, T* scratch_all) {
  const size_t D2 = size_t(tb.Dc) * tb.Dc, D3 = D2 * tb.Dc;
  const T* nhi = nhi_all + blockIdx.x * D3;
  T* box = box_all + blockIdx.x * D3;
  T* sc = scratch_all + blockIdx.x * 12 * D2;
  const T* pin = planes_in + blockIdx.x * 6 * D2;
  T* pout = planes_out + blockIdx.x * 6 * D2;
  T* carry = sc + ((r0 - 1) & 1) * 6 * D2;
  for (size_t i = threadIdx.x; i < 6 * D2; i += blockDim.x) carry[i] = pin[i];
  __syncthreads();
  sweep_shells(tb, nhi, sc, r0, r1, StoreCd<T>{box});
  const T* last = sc + ((max(r1, r0) - 1) & 1) * 6 * D2;
  for (size_t i = threadIdx.x; i < 6 * D2; i += blockDim.x) pout[i] = last[i];
}

template <typename T>
Tables<T> tables(const void* sw, const void* path, const void* diag,
                 const void* mask_m, const void* mask_p, int Dc, int c, int R1,
                 double dr, double sig) {
  return Tables<T>{static_cast<const T*>(sw), static_cast<const T*>(path),
                   static_cast<const T*>(diag),
                   static_cast<const uint8_t*>(mask_m),
                   static_cast<const uint8_t*>(mask_p), Dc, c, R1,
                   static_cast<T>(dr), static_cast<T>(sig)};
}

}  // namespace

#define CHEB_TABLES_ARGS                                                      \
  const void *nhi, const void *sw, const void *path, const void *diag,      \
      const void *mask_m, const void *mask_p

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// after the launch.

int cheb_sweep_f32(CHEB_TABLES_ARGS, void* box, void* scratch, int B, int Dc,
                   int c, int R1, double dr, double sig, int threads,
                   void* stream) {
  cheb_sweep_kernel<float><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables<float>(sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig),
      static_cast<const float*>(nhi), static_cast<float*>(box),
      static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

int cheb_sweep_f64(CHEB_TABLES_ARGS, void* box, void* scratch, int B, int Dc,
                   int c, int R1, double dr, double sig, int threads,
                   void* stream) {
  cheb_sweep_kernel<double><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables<double>(sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig),
      static_cast<const double*>(nhi), static_cast<double*>(box),
      static_cast<double*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

int cheb_sweep_gamma_f32(CHEB_TABLES_ARGS, const void* rt, const void* bins_s,
                         const void* bins_w, void* box, void* scratch, int B,
                         int Dc, int c, int R1, int E, double dr, double sig,
                         double R2, double sdr3, int threads, void* stream) {
  cheb_sweep_gamma_kernel<float>
      <<<B, threads, 2 * E * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
          tables<float>(sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig),
          static_cast<const float*>(nhi), static_cast<const float*>(rt),
          static_cast<const float*>(bins_s), static_cast<const float*>(bins_w),
          E, static_cast<float>(R2), static_cast<float>(sdr3),
          static_cast<float*>(box), static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

int cheb_sweep_gamma_f64(CHEB_TABLES_ARGS, const void* rt, const void* bins_s,
                         const void* bins_w, void* box, void* scratch, int B,
                         int Dc, int c, int R1, int E, double dr, double sig,
                         double R2, double sdr3, int threads, void* stream) {
  cheb_sweep_gamma_kernel<double>
      <<<B, threads, 2 * E * sizeof(double), static_cast<cudaStream_t>(stream)>>>(
          tables<double>(sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig),
          static_cast<const double*>(nhi), static_cast<const double*>(rt),
          static_cast<const double*>(bins_s), static_cast<const double*>(bins_w),
          E, R2, sdr3, static_cast<double*>(box), static_cast<double*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

int cheb_sweep_seg_f32(CHEB_TABLES_ARGS, const void* planes_in,
                       void* planes_out, void* box, void* scratch, int B,
                       int Dc, int c, int R1, int r0, int r1, double dr,
                       double sig, int threads, void* stream) {
  cheb_sweep_seg_kernel<float><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables<float>(sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig),
      static_cast<const float*>(nhi), static_cast<const float*>(planes_in),
      static_cast<float*>(planes_out), r0, r1, static_cast<float*>(box),
      static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

int cheb_sweep_seg_f64(CHEB_TABLES_ARGS, const void* planes_in,
                       void* planes_out, void* box, void* scratch, int B,
                       int Dc, int c, int R1, int r0, int r1, double dr,
                       double sig, int threads, void* stream) {
  cheb_sweep_seg_kernel<double><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables<double>(sw, path, diag, mask_m, mask_p, Dc, c, R1, dr, sig),
      static_cast<const double*>(nhi), static_cast<const double*>(planes_in),
      static_cast<double*>(planes_out), r0, r1, static_cast<double*>(box),
      static_cast<double*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

const char* cheb_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
