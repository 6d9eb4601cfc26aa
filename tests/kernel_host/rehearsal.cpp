// Runs the port's kernels on the host: k_loop.inc, k_chem.inc,
// k_flat_probe.inc and k_box_probe.inc are the device parts of
// trace_loop.cu, chemistry.cu, flat_probe.cu and box_probe.cu,
// thermal.cuh and flat_sweep.cuh those of the thermal update's and the
// flat engine's kernels, cheb_sweep_kernels.cuh,
// cheb_sweep_rates.cuh, cheb_rates.cuh and cheb_rates_he.cuh those of the
// headers of K1, K1f and K2, of K3, and of the dense rate passes, as
// tests/rehearsal_host.py cuts them out,
// compiled against the stand-in headers of this directory. One cluster
// (source) runs at a time, its C blocks x T threads as std::threads: the
// chain threads and, behind them, the rate threads of K1f. K3's phase B,
// the box kernels, the start of a segmented sweep, the dense rate passes,
// the chemistry passes and the thermal update are plain grids: their
// blocks run one after the other (all but phase B's also in reverse
// order), each as T std::threads; the accumulate's grid has a second
// dimension, its boxes. The flat sweep runs as K1 does, a cluster a
// source; the flat gather a block at a time, its threads as std::threads;
// the rate pass and accumulate one thread after the other (the
// accumulate's one barrier follows its block's first thread's work, which
// needs no other thread).
#include <thread>
#include <type_traits>
#include "cuda_runtime.h"
thread_local uint3_ threadIdx, blockIdx, blockDim, gridDim;
thread_local EmuCluster* emu_cl;
thread_local int emu_rank;
thread_local std::optional<std::barrier<>::arrival_token> emu_token;
#include "cheb_sweep_kernels.cuh"
#include "cheb_sweep_rates.cuh"
#include "cheb_rates.cuh"
#include "cheb_rates_he.cuh"
#include "k_loop.inc"
#include "k_chem.inc"
#include "thermal.cuh"
#include "flat_sweep.cuh"
#include "k_flat_probe.inc"
#include "box_sweep.cuh"
#include "k_box_probe.inc"
using namespace cheb;

template <class F>
void emu_launch(int B, int C, int T, size_t smem, F f, bool reverse = false) {
  for (int i = 0; i < B; ++i) {
    const int src = reverse ? B - 1 - i : i;
    EmuCluster cl;
    cl.C = C; cl.T = T; cl.smem = smem;
    std::barrier<> cbar(C * T);
    cl.cluster_bar = &cbar;
    for (int k = 0; k < C; ++k) {
      cl.bufs.emplace_back(smem + 16, 0xee);
      cl.block_bar.push_back(new std::barrier<>(T));
      cl.warp_bar.emplace_back();
      for (int w = 0; 32 * w < T; ++w)
        cl.warp_bar[k].push_back(new std::barrier<>(std::min(32, T - 32 * w)));
      cl.ballot.emplace_back(cl.warp_bar[k].size(), 0u);
    }
    std::vector<std::thread> th;
    for (int k = 0; k < C; ++k)
      for (int t = 0; t < T; ++t)
        th.emplace_back([&, k, t] {
          emu_cl = &cl;
          emu_rank = k;
          threadIdx = {unsigned(t), 0, 0};
          blockIdx = {unsigned(src * C + k), 0, 0};
          blockDim = {unsigned(T), 1, 1};
          gridDim = {unsigned(B * C), 1, 1};
          f();
        });
    for (auto& x : th) x.join();
    for (auto* p : cl.block_bar) delete p;
    for (auto& ws : cl.warp_bar)
      for (auto* p : ws) delete p;
  }
}

// What a rehearsal takes: the kernels' tensors (null where a kind has none)
// and scalars, and the launch plan.
struct Args {
  const void *nhi, *sw, *path, *diag, *mm, *mp, *rt, *bs, *bw, *bwh, *flux,
      *pin;
  void *pout, *box, *box2, *ci, *dc, *scratch;
  int B, Dc, c, R1, E, r0, r1;
  double dr, sig, R2, sdr3, s_fac;
  int threads, C, sh, smem, rate_threads, ring;
};

// kind 0: K1, 1: K1f, 2: K2, 3: K3 (box = phi), 4: K3h (box = phi, box2 =
// heat), both through ci and dc. Returns 1 where make_plan refuses the
// caller's sizes.
template <class T>
int run(int kind, const Args& a) {
  const Tables<T> tb = make_tables<T>(a.sw, a.path, a.diag, a.mm, a.mp, a.Dc,
                                      a.c, a.R1, a.dr, a.sig);
  const LaunchSpec spec{a.B, a.threads, a.C, a.sh, a.smem, a.rate_threads,
                        a.ring, nullptr, nullptr};
  Plan pl;
  if (make_plan<T>(spec, a.Dc, kind == 1 ? 2 * a.E : 0, kind == 1, &pl) !=
      cudaSuccess)
    return 1;
  auto N = static_cast<const T*>(a.nhi);
  auto S = static_cast<T*>(a.scratch);
  auto call = [&](auto shared) {
    constexpr bool SH = decltype(shared)::value;
    emu_launch(a.B, a.C, a.threads + a.rate_threads, a.smem, [&] {
      if (kind == 0)
        cheb_sweep_kernel<T, SH>(tb, pl, N, (T*)a.box, S);
      else if (kind == 1)
        cheb_sweep_gamma_kernel<T, SH>(tb, pl, N, (const T*)a.rt,
                                       (const T*)a.flux, (const T*)a.bs,
                                       (const T*)a.bw, a.E, T(a.R2), T(a.sdr3),
                                       (T*)a.box, S);
      else if (kind == 2)
        cheb_sweep_seg_kernel<T, SH>(tb, pl, N, (const T*)a.pin, (T*)a.pout,
                                     a.r0, a.r1, (T*)a.box, S);
      else
        sweep_fold_kernel<T, SH>(tb, pl, N, (T*)a.ci, (T*)a.dc, S);
    });
  };
  if (a.sh) call(std::true_type{}); else call(std::false_type{});
  if (kind >= 3) {               // phase B: B x Dc blocks, the bins shared
    const size_t smem = (kind == 4 ? 3 : 2) * a.E * sizeof(T);
    emu_launch(a.B * a.Dc, 1, a.threads, smem, [&] {
      auto phase_b = kind == 4 ? box_rates_kernel<T, true>
                               : box_rates_kernel<T, false>;
      phase_b(N, (const T*)a.ci, (const T*)a.dc, (const T*)a.rt,
              (const T*)a.flux, (const T*)a.bs, (const T*)a.bw,
              (const T*)a.bwh, a.E, a.Dc, a.c, T(a.dr), T(a.sig), T(a.s_fac),
              T(a.sdr3), (T*)a.box, (T*)a.box2);
    });
  }
  return 0;
}

extern "C" int rehearse_f32(int kind, const Args* a) { return run<float>(kind, *a); }
extern "C" int rehearse_f64(int kind, const Args* a) { return run<double>(kind, *a); }

// The accumulate of trace_loop.cu over n channels of batch `batch`: the
// n_cells listed cells `cells` of every box (all D^3 where `cells` is null),
// min(ceil(n / T), kRangesPerPlane D) x B blocks of T threads with the
// launch's shared memory, in reverse block order with `reverse`.
template <class T>
void run_boxes(void* const* frames, void* const* boxes, int n,
               const int* pos, int batch, int B, int D, int shift, int F0,
               int F1, int F2, const int* cells, const void* valid,
               int n_cells, int T_, int reverse) {
  Channels<T> ch{};
  ch.n = n;
  for (int c = 0; c < n; ++c) {
    ch.frame[c] = static_cast<T*>(frames[c]);
    ch.box[c] = static_cast<T*>(boxes[c]);
  }
  const BoxSet bs{pos, batch, B, D, shift, F0, F1, F2};
  const Visit<T> vis{cells, static_cast<const T*>(valid),
                     cells ? n_cells : D * D * D};
  const int ranges = std::min((vis.n + T_ - 1) / T_, kRangesPerPlane * D);
  const size_t smem = sizeof(unsigned) * ((T_ + 31) / 32) * ((B + 31) / 32) +
                      (B <= kStagedCorners ? 3 * sizeof(int) * B : 0);
  for (int i = 0; i < B; ++i) {
    const unsigned y = unsigned(reverse ? B - 1 - i : i);
    emu_launch(ranges, 1, T_, smem, [&] {
      blockIdx.y = y;
      gridDim.y = unsigned(B);
      if (B <= kStagedCorners)
        accumulate_boxes_kernel<T, true>(ch, bs, vis);
      else
        accumulate_boxes_kernel<T, false>(ch, bs, vis);
    }, reverse != 0);
  }
}

// The extract of the chunk of batches k0 .. k0 + k - 1 of n channels (the
// frames of strides (S0, S1, 1)) into boxes[c], (k, B, D, D, D) each, over
// the launch's grid (extract_grid) of kBoxThreads threads a block, in
// reverse block order with `reverse`.
template <class T>
void run_extract(void* const* frames, void* const* boxes, int n,
                 const int* pos, int k0, int k, int B, int D, long long S0,
                 long long S1, int reverse) {
  Channels<T> ch{};
  ch.n = n;
  for (int c = 0; c < n; ++c) {
    ch.frame[c] = static_cast<T*>(frames[c]);
    ch.box[c] = static_cast<T*>(boxes[c]);
  }
  const Chunk cs{pos, k0, k, B, D, S0, S1};
  const ExtractGrid g = extract_grid<T>(cs);
  constexpr int W = 16 / sizeof(T);
  emu_launch(int(g.blocks), 1, kBoxThreads, 0, [&] {
    if (n == 1 && g.V == W)
      extract_chunk_kernel<T, W, 1>(ch, cs, g.row_vecs, g.box_rows, g.side,
                                    g.n_vec);
    else if (n == 1)
      extract_chunk_kernel<T, 1, 1>(ch, cs, g.row_vecs, g.box_rows, g.side,
                                    g.n_vec);
    else if (g.V == W)
      extract_chunk_kernel<T, W, kMaxChannels>(ch, cs, g.row_vecs,
                                               g.box_rows, g.side, g.n_vec);
    else
      extract_chunk_kernel<T, 1, kMaxChannels>(ch, cs, g.row_vecs,
                                               g.box_rows, g.side, g.n_vec);
  }, reverse != 0);
}

#define REHEARSE_EXTRACT(NAME, TYPE)                                           \
  extern "C" void NAME(void* const* frames, void* const* boxes, int n,         \
                       const int* pos, int k0, int k, int B, int D,            \
                       long long S0, long long S1, int reverse) {              \
    run_extract<TYPE>(frames, boxes, n, pos, k0, k, B, D, S0, S1, reverse);    \
  }
REHEARSE_EXTRACT(rehearse_extract_f32, float)
REHEARSE_EXTRACT(rehearse_extract_f64, double)

#define REHEARSE_BOXES(NAME, TYPE)                                             \
  extern "C" void NAME(void* const* frames, void* const* boxes, int n,         \
                       const int* pos, int batch, int B, int D, int shift,     \
                       int F0, int F1, int F2, const int* cells,               \
                       const void* valid, int n_cells, int T_, int reverse) {  \
    run_boxes<TYPE>(frames, boxes, n, pos, batch, B, D, shift, F0, F1, F2,     \
                    cells, valid, n_cells, T_, reverse);                       \
  }
REHEARSE_BOXES(rehearse_boxes_f32, float)
REHEARSE_BOXES(rehearse_boxes_f64, double)

// The start of a segmented sweep (init_segments_kernel) of B boxes of side
// Dc, B x Dc blocks of T_ threads, in reverse block order with `reverse`.
template <class T>
void run_init(const void* nhi, void* box, void* planes, int B, int Dc, int c,
              double dr, int T_, int reverse) {
  emu_launch(B * Dc, 1, T_, 0, [&] {
    init_segments_kernel<T>(static_cast<const T*>(nhi), static_cast<T*>(box),
                            static_cast<T*>(planes), Dc, c, T(dr));
  }, reverse != 0);
}

// The dense rate pass (rates_dense_kernel, the heat form where `heat` is
// set) over B boxes at the n_valid listed cells: ceil(B n_valid / T_)
// blocks of T_ threads, in reverse block order with `reverse`. `f` holds
// cd, nhi, rt, cells, flux, bins_s, bins_w, bins_wh, phi, heat.
template <class T>
void run_rates(void* const* f, int B, int E, int Dc, int Ds, int rb0,
               int n_valid, double dr, double sig, double sdr3, int T_,
               int reverse) {
  using P = const T*;
  const DenseRates<T> k{(P)f[0], (P)f[1], (P)f[2], (const int*)f[3],
                        (P)f[4], (P)f[5], (P)f[6], (P)f[7], (T*)f[8],
                        (T*)f[9], B, E, Dc, Ds, rb0, n_valid, T(dr), T(sig),
                        T(sdr3)};
  const size_t n = size_t(B) * n_valid;
  const bool heat = f[9] != nullptr;
  emu_launch(int((n + T_ - 1) / T_), 1, T_, (heat ? 3 : 2) * E * sizeof(T),
             [&] {
               if (heat)
                 rates_dense_kernel<T, true>(k);
               else
                 rates_dense_kernel<T, false>(k);
             }, reverse != 0);
}

#define REHEARSE_RATES(INIT, RATES, TYPE)                                      \
  extern "C" void INIT(const void* nhi, void* box, void* planes, int B,        \
                       int Dc, int c, double dr, int T_, int reverse) {        \
    run_init<TYPE>(nhi, box, planes, B, Dc, c, dr, T_, reverse);               \
  }                                                                            \
  extern "C" void RATES(void* const* f, int B, int E, int Dc, int Ds, int rb0, \
                        int n_valid, double dr, double sig, double sdr3,       \
                        int T_, int reverse) {                                 \
    run_rates<TYPE>(f, B, E, Dc, Ds, rb0, n_valid, dr, sig, sdr3, T_,          \
                    reverse);                                                  \
  }
REHEARSE_RATES(rehearse_init_f32, rehearse_rates_f32, float)
REHEARSE_RATES(rehearse_init_f64, rehearse_rates_f64, double)

// The helium rate pass (rates_he_kernel, the heat form where `f[12]`,
// out3, is set) over B boxes at the n_valid listed cells: ceil(B n_valid /
// T_) blocks of T_ threads, in reverse block order with `reverse`. `f`
// holds cd0..cd2, n0..n2, rt, cells, flux, the records, the bands' header
// (kHeHead ints), out0..out3. Returns 1 where the launch code refuses the
// sizes (he_rates_fit).
template <class T>
int run_rates_he(void* const* f, int B, int Dc, int Ds, int rb0,
                 int n_valid, double dr, double sdr3, int T_, int reverse) {
  using P = const T*;
  const HeRates<T> k{{(P)f[0], (P)f[1], (P)f[2]}, {(P)f[3], (P)f[4], (P)f[5]},
                     (P)f[6], (const int*)f[7], (P)f[8], (P)f[9],
                     he_bands_of((const int*)f[10]),
                     {(T*)f[11], (T*)f[12], (T*)f[13], (T*)f[14]},
                     B, Dc, Ds, rb0, n_valid, T(dr), T(sdr3)};
  if (!he_rates_fit(k)) return 1;
  const size_t n = size_t(B) * n_valid;
  const bool heat = f[14] != nullptr;
  emu_launch(int((n + T_ - 1) / T_), 1, T_, he_rates_smem(k), [&] {
    if (heat)
      rates_he_kernel<T, true>(k);
    else
      rates_he_kernel<T, false>(k);
  }, reverse != 0);
  return 0;
}

// Whether he_trace_sweep takes a call of these sizes (he_loop_fits): every
// buffer given but the heat channel's frame (`heat_out`), K2's planes
// (`planes`) and the list of rated cells (`cells`) as the flags say, the
// rate pass's records those of `v[1]` bins of all three species' terms
// (band 3), with the heat channel's table where `heat_bins`.
template <class T>
int run_he_fits(const int* v, int heat_bins, int heat_out, int planes,
                int cells) {
  static double dummy;
  void* p = &dummy;
  const int iters = (v[1] + kHeUnroll - 1) / kHeUnroll;
  const int rec = heat_bins ? he_record<T, kHeSpecies, true>()
                            : he_record<T, kHeSpecies, false>();
  // heat, n_rec, passes, offsets, species of the three bands
  const int head[kHeHead] = {heat_bins, iters * kHeUnroll * rec, 0, 0, iters,
                             0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 2};
  const HeLoopBufs a{{p, p, p}, (const int*)p, p, p,
                     cells ? (const int*)p : nullptr, p, head,
                     {p, p, p, heat_out ? p : nullptr},
                     p, p, p, {planes ? p : nullptr, planes ? p : nullptr},
                     nullptr};
  // v: nb, E, rb0, Ds, n_valid, seg_S, seg_K, F0, F1, F2, chunk, B, Dc, c, R1
  const HeLoopArgs s{v[0], 1e-3, {1e-18, 1e-18}, v[2], v[3], v[4], v[5],
                     v[6], v[7], v[8], v[9], v[10]};
  return he_loop_fits<T>(a, s, v[11], v[12], v[13], v[14]) ? 1 : 0;
}

#define REHEARSE_HE(RATES, FITS, TYPE)                                         \
  extern "C" int RATES(void* const* f, int B, int Dc, int Ds, int rb0,         \
                       int n_valid, double dr, double sdr3, int T_,            \
                       int reverse) {                                          \
    return run_rates_he<TYPE>(f, B, Dc, Ds, rb0, n_valid, dr, sdr3, T_,        \
                              reverse);                                        \
  }                                                                            \
  extern "C" int FITS(const int* v, int heat_bins, int heat_out, int planes,   \
                      int cells) {                                             \
    return run_he_fits<TYPE>(v, heat_bins, heat_out, planes, cells);           \
  }
REHEARSE_HE(rehearse_rates_he_f32, rehearse_he_fits_f32, float)
REHEARSE_HE(rehearse_rates_he_f64, rehearse_he_fits_f64, double)

// The chemistry passes of chemistry.cu over n cells, `blocks` blocks of
// T_ threads striding over them, in reverse block order with `reverse`.
// `f` holds the pointers in the order of the source's entry points: for
// the hydrogen pass ndens, temp, xh, xh_av, phi, mask, xh_out, xh_av_out,
// count, iters; for helium (`helium` = 1 + 2 heat + 4 recomb) ndens, temp,
// xh, xh_av, y1, y1_av, y2, y2_av, phi_h, phi_he1, phi_he2, heat, mask,
// the six outputs, count, iters.
template <class T>
void run_chem(int helium, void* const* f, long long n, int cap,
              const double* params, int dt_kind, const void* dt_ptr,
              double dt_value, int blocks, int T_, int reverse) {
  using P = const T*;
  const chem::Dt dt{dt_ptr, dt_kind, dt_value};
  const size_t smem = T_ * sizeof(unsigned);
  if (helium == 0) {
    const chem::HArgs<T> a{(P)f[0], (P)f[1], (P)f[2], (P)f[3], (P)f[4],
                           (const bool*)f[5], (T*)f[6], (T*)f[7],
                           (unsigned long long*)f[8], (int*)f[9], n, cap, dt,
                           chem::h_const<T>(params)};
    emu_launch(blocks, 1, T_, smem, [&] { chem::hydrogen_pass_kernel<T>(a); },
               reverse != 0);
    return;
  }
  const chem::HeArgs<T> a{
      (P)f[0], (P)f[1], (P)f[2], (P)f[3], (P)f[4], (P)f[5], (P)f[6],
      (P)f[7], (P)f[8], (P)f[9], (P)f[10], (P)f[11], (const bool*)f[12],
      (T*)f[13], (T*)f[14], (T*)f[15], (T*)f[16], (T*)f[17], (T*)f[18],
      (unsigned long long*)f[19], (int*)f[20], n, cap, dt,
      chem::he_const<T>(params)};
  emu_launch(blocks, 1, T_, smem, [&] {
    switch (helium >> 1) {
      case 0: chem::helium_pass_kernel<T, false, false>(a); break;
      case 1: chem::helium_pass_kernel<T, true, false>(a); break;
      case 2: chem::helium_pass_kernel<T, false, true>(a); break;
      default: chem::helium_pass_kernel<T, true, true>(a); break;
    }
  }, reverse != 0);
}

#define REHEARSE_CHEM(NAME, TYPE)                                              \
  extern "C" void NAME(int helium, void* const* f, long long n, int cap,       \
                       const double* params, int dt_kind, const void* dt_ptr,  \
                       double dt_value, int blocks, int T_, int reverse) {     \
    run_chem<TYPE>(helium, f, n, cap, params, dt_kind, dt_ptr, dt_value,       \
                   blocks, T_, reverse);                                       \
  }
REHEARSE_CHEM(rehearse_chem_f32, float)
REHEARSE_CHEM(rehearse_chem_f64, double)

// The thermal update of thermal.cuh over n cells, `blocks` blocks of T_
// threads striding over them, in reverse block order with `reverse`: the
// engine's kernel for its arguments (form -1, thermal::dispatch) or the
// design step `form` (thermal::run_form). `f` holds temp, ndens, xh, heat,
// out. Returns the launch's code (run_form's 1 for a form that does not
// take the arguments).
struct HostThermal {
  int blocks, T_;
  bool reverse;
  template <int NSUB, int COMPTON, unsigned F, typename T>
  int run(thermal::TArgs<T> a) const {
    emu_launch(blocks, 1, T_, 0,
               [&] { thermal::thermal_kernel<T, NSUB, COMPTON, F>(a); },
               reverse);
    return 0;
  }
};

template <class T>
int run_thermal(void* const* f, long long n, int nsub, const double* params,
                int dt_kind, const void* dt_ptr, double dt_value, int blocks,
                int T_, int reverse, int form) {
  using P = const T*;
  const thermal::TArgs<T> a{(P)f[0], (P)f[1], (P)f[2], (P)f[3], (T*)f[4], n,
                            nsub, thermal::Dt{dt_ptr, dt_kind, dt_value},
                            thermal::t_const<T>(params, nsub)};
  const HostThermal l{blocks, T_, reverse != 0};
  return form < 0 ? thermal::dispatch(a, l) : thermal::run_form(form, a, l);
}

#define REHEARSE_THERMAL(NAME, TYPE)                                           \
  extern "C" int NAME(void* const* f, long long n, int nsub,                   \
                      const double* params, int dt_kind, const void* dt_ptr,   \
                      double dt_value, int blocks, int T_, int reverse,        \
                      int form) {                                              \
    return run_thermal<TYPE>(f, n, nsub, params, dt_kind, dt_ptr, dt_value,    \
                             blocks, T_, reverse, form);                       \
  }
REHEARSE_THERMAL(rehearse_thermal_f32, float)
REHEARSE_THERMAL(rehearse_thermal_f64, double)

// A grid of blocks x rows blocks of T_ threads for a kernel whose threads
// never wait for each other (no barrier, no shared memory): each thread in
// turn on the calling thread, the blocks of a row and the rows in reverse
// order with `reverse`.
template <class F>
void emu_serial(int blocks, int rows, int T_, F f, bool reverse) {
  for (int r = 0; r < rows; ++r)
    for (int k = 0; k < blocks; ++k)
      for (int t = 0; t < T_; ++t) {
        blockIdx = {unsigned(reverse ? blocks - 1 - k : k),
                    unsigned(reverse ? rows - 1 - r : r), 0};
        threadIdx = {unsigned(t), 0, 0};
        blockDim = {unsigned(T_), 1, 1};
        gridDim = {unsigned(blocks), unsigned(rows), 1};
        f();
      }
}

// A grid of blocks x rows blocks of T_ threads whose threads wait for each
// other (__syncthreads) in a block: each block in turn, its threads as
// std::threads over `smem` bytes of shared memory (the bytes 0xee), the
// blocks of a row and the rows in reverse order with `reverse`.
template <class F>
void emu_blocks(int blocks, int rows, int T_, size_t smem, F f,
                bool reverse) {
  for (int r = 0; r < rows; ++r)
    for (int k = 0; k < blocks; ++k) {
      EmuCluster cl;
      cl.C = 1; cl.T = T_; cl.smem = smem;
      std::barrier<> one(T_);
      cl.block_bar.push_back(&one);
      cl.bufs.emplace_back(smem + 16, 0xee);
      std::vector<std::thread> th;
      for (int t = 0; t < T_; ++t)
        th.emplace_back([&, t] {
          emu_cl = &cl;
          emu_rank = 0;
          blockIdx = {unsigned(reverse ? blocks - 1 - k : k),
                      unsigned(reverse ? rows - 1 - r : r), 0};
          threadIdx = {unsigned(t), 0, 0};
          blockDim = {unsigned(T_), 1, 1};
          gridDim = {unsigned(blocks), unsigned(rows), 1};
          f();
        });
      for (auto& x : th) x.join();
    }
}

// The flat engine's kernels of flat_sweep.cuh and the probe's forms of
// flat_probe.cu over the engine's tables (tabs, dims, vals as make_geom
// takes them). kind 0: the gather and the sweep of batch 0 (B clusters of
// `cluster` blocks of T_ threads) in the engine's form `form` (kEngineRing
// or kEngineGlobal) or a probe form (FLAT_PROBE_FORMS, with a gather first
// where the form reads nHI gathered and has no prologue: the grid-order
// form, thread after thread, the same values as the engine's, which kinds
// 3 and 4 rehearse);
// 1: the engine's rate pass of batch 0 (its rated cells, ceil(n_rated / T_)
// x B blocks, thread after thread); 2: its accumulate
// (ceil(C / T_) x B blocks of T_ threads, run one after the other: the
// accumulate's threads wait once for their block's first thread, which
// runs first); 3: the trace of nb batches, the rate scratch zeroed first as
// the loop zeroes it, then each batch's gather and sweep, rates and
// accumulate in turn; 4: the gather of batch 0 into nhi_octa, the engine's
// (form 2: n_blk x B blocks of T_ threads) or the probe's (0: grid order, 1:
// octahedral order, 3: the first staged form, 4 and 5: the engine's with 8
// or 16 loads in flight a lane); 5: the probe's rate pass of form `form`
// (F | K << 4) of batch 0. The clusters, the blocks of a row and the rows
// in reverse order with `reverse`. `io` holds nhi, pos (int32 in [0, N)),
// flux, sdr3, cd, phi, heat, phi_grid, heat_grid (the heat channel's null
// without it) and nhi_octa.
constexpr int kEngineRing = -1, kEngineGlobal = -2;

template <class T>
void emu_flat_gather(const flat::Geom<T>& g, const flat::Trace<T>& tr, int b,
                     int T_, bool reverse, int form = 2) {
  if (form >= 2 && form <= 5) {
    emu_blocks(g.n_blk, tr.B, T_,
               form != 3 ? flat::gather_smem(g) : size_t(g.g_cells) * sizeof(T),
               [&] {
      if (form == 2)
        flat::flat_gather_kernel<T>(g, tr.nhi, tr.pos_of(b), tr.nhi_octa);
      else if (form == 3)
        flat_probe::gather_staged_first_kernel<T>(g, tr.nhi, tr.pos_of(b),
                                                  tr.nhi_octa);
      else if (form == 4)
        flat::flat_gather_kernel<T, 8>(g, tr.nhi, tr.pos_of(b), tr.nhi_octa);
      else
        flat::flat_gather_kernel<T, 16>(g, tr.nhi, tr.pos_of(b),
                                        tr.nhi_octa);
    }, reverse);
    return;
  }
  emu_serial((g.C + T_ - 1) / T_, tr.B, T_, [&] {
    if (form == 0)
      flat_probe::gather_grid_order_kernel<T>(g, tr.nhi, tr.pos_of(b),
                                              tr.nhi_octa);
    else
      flat_probe::gather_octa_kernel<T>(g, tr.nhi, tr.pos_of(b),
                                        tr.nhi_octa);
  }, reverse);
}

template <class T, int F>
void emu_flat_sweep(const flat::Geom<T>& g, const flat::Trace<T>& tr, int b,
                    int cluster, int T_, bool reverse, int gather) {
  int lgC = 0;
  while ((1 << lgC) < cluster) ++lgC;
  const size_t smem = ((F & flat_probe::kRing) ? size_t(g.depth) *
      (flat::kChunks / cluster) * g.max_u * sizeof(T) : 0) +
      ((F & flat_probe::kStage) ? flat_probe::stage_bytes<T>(T_) : 0);
  if ((F & flat_probe::kPre) && !(F & flat_probe::kPrologue))
    emu_flat_gather<T>(g, tr, b, 32, reverse, gather);
  emu_launch(tr.B, cluster, T_, smem, [&] {
    flat_probe::sweep_form_kernel<T, F>(g, tr.nhi, tr.pos_of(b),
                                        tr.nhi_octa, tr.cd, lgC);
  }, reverse);
}

template <class T>
void emu_flat_sweep(int form, const flat::Geom<T>& g,
                    const flat::Trace<T>& tr, int b, int cluster, int T_,
                    bool reverse, int gather) {
  using namespace flat_probe;
  if (form == kEngineRing || form == kEngineGlobal) {
    int lgC = 0;
    while ((1 << lgC) < cluster) ++lgC;
    const bool ring = form == kEngineRing;
    emu_flat_gather<T>(g, tr, b, 32, reverse, gather);
    const size_t smem = ring ? size_t(flat::ring_bytes(g, cluster)) : 0;
    emu_launch(tr.B, cluster, T_, smem, [&] {
      if (ring)
        flat::flat_sweep_kernel<T, true>(g, tr.nhi, tr.pos_of(b),
                                         tr.nhi_octa, tr.cd, lgC);
      else
        flat::flat_sweep_kernel<T, false>(g, tr.nhi, tr.pos_of(b),
                                          tr.nhi_octa, tr.cd, lgC);
    }, reverse);
    return;
  }
#define FLAT_FORM(F)                                                           \
  case F:                                                                      \
    emu_flat_sweep<T, F>(g, tr, b, cluster, T_, reverse, gather);              \
    return;
  switch (form) {
    FLAT_PROBE_FORMS(FLAT_FORM)
    default:
      __builtin_trap();
  }
#undef FLAT_FORM
}

template <class T>
void emu_flat_rates_form(const flat::Geom<T>& g, const flat::RateIO<T>& a,
                         const T* nhi, const int* pos, int T_, int form,
                         bool reverse) {
  using namespace flat_probe;
#define FLAT_RATE_FORM(F, K)                                                   \
  if (form == ((F) | (K) << 4)) {                                              \
    const int n = (F) & kList ? g.n_rated : g.C;                               \
    emu_serial((n + T_ - 1) / T_, (a.B + (K) - 1) / (K), T_, [&] {             \
      if (a.heat)                                                              \
        rates_form_kernel<T, true, F, K>(g, a, nhi, pos);                      \
      else                                                                     \
        rates_form_kernel<T, false, F, K>(g, a, nhi, pos);                     \
    }, reverse);                                                               \
    return;                                                                    \
  }
  FLAT_RATE_FORMS(FLAT_RATE_FORM)
#undef FLAT_RATE_FORM
  __builtin_trap();
}

template <class T>
void run_flat(int kind, void* const* tabs, const int* dims,
              const double* vals, void* const* io, int nb, int B, int cluster,
              int T_, int reverse, int form) {
  using P = const T*;
  const flat::Geom<T> g = flat::make_geom<T>(tabs, dims, vals);
  const flat::Trace<T> tr{(P)io[0], (const int*)io[1], (P)io[2], (P)io[3],
                          (T*)io[9], (T*)io[4], (T*)io[5], (T*)io[6],
                          (T*)io[7], (T*)io[8], B};
  const int blocks = (g.C + T_ - 1) / T_;
  if (kind == 3) {
    std::fill(tr.phi, tr.phi + size_t(B) * g.C, T(0));
    if (tr.heat) std::fill(tr.heat, tr.heat + size_t(B) * g.C, T(0));
  }
  if (kind == 4) {
    emu_flat_gather<T>(g, tr, 0, T_, reverse != 0, form);
    return;
  }
  if (kind == 5) {
    emu_flat_rates_form<T>(g, tr.rates(0), tr.nhi, tr.pos_of(0), T_, form,
                           reverse != 0);
    return;
  }
  for (int b = 0; b < (kind == 3 ? nb : 1); ++b) {
    if (kind == 0 || kind == 3)
      emu_flat_sweep<T>(form, g, tr, b, cluster, T_, reverse != 0,
                        kind == 3 ? 2 : 0);
    if (kind == 1 || kind == 3) {
      const flat::RateIO<T> a = tr.rates(b);
      emu_serial((g.n_rated + T_ - 1) / T_, B, T_, [&] {
        if (g.grey)
          flat::flat_rates_kernel<T, true, false>(g, a);
        else if (a.heat)
          flat::flat_rates_kernel<T, false, true>(g, a);
        else
          flat::flat_rates_kernel<T, false, false>(g, a);
      }, reverse != 0);
    }
    if (kind == 2 || kind == 3) {
      // the block's first thread lists the near sources before its barrier:
      // run thread after thread, the barrier of a block of one
      const flat::AccIO<T> a = tr.acc(b);
      EmuCluster cl;
      cl.C = 1; cl.T = 1; cl.smem = sizeof(int) * (B + 1);
      std::barrier<> one(1);
      cl.block_bar.push_back(&one);
      cl.bufs.emplace_back(cl.smem + 16, 0xee);
      emu_cl = &cl;
      emu_rank = 0;
      emu_serial(blocks, B, T_, [&] {
        if (a.heat)
          flat::flat_accumulate_kernel<T, true>(g, a);
        else
          flat::flat_accumulate_kernel<T, false>(g, a);
      }, reverse != 0);
      emu_cl = nullptr;
    }
  }
}

#define REHEARSE_FLAT(NAME, TYPE)                                              \
  extern "C" void NAME(int kind, void* const* tabs, const int* dims,          \
                       const double* vals, void* const* io, int nb, int B,    \
                       int cluster, int T_, int reverse, int form) {          \
    run_flat<TYPE>(kind, tabs, dims, vals, io, nb, B, cluster, T_, reverse,   \
                   form);                                                     \
  }
REHEARSE_FLAT(rehearse_flat_f32, float)
REHEARSE_FLAT(rehearse_flat_f64, double)

// The forms of the flat sweep the engine runs, (ring, global), then the
// probe's (FLAT_PROBE_FORMS), then -100; the probe's rate forms
// (FLAT_RATE_FORMS) and -100.
extern "C" void rehearse_flat_forms(int* out, int* rates) {
  using namespace flat_probe;
  int k = 0;
  out[k++] = kEngineRing;
  out[k++] = kEngineGlobal;
#define FLAT_FORM_ITEM(F) out[k++] = F;
  FLAT_PROBE_FORMS(FLAT_FORM_ITEM)
#undef FLAT_FORM_ITEM
  out[k] = -100;
  k = 0;
#define FLAT_RATE_ITEM(F, K) rates[k++] = (F) | (K) << 4;
  FLAT_RATE_FORMS(FLAT_RATE_ITEM)
#undef FLAT_RATE_ITEM
  rates[k] = -100;
}

// The box engine's kernels of box_sweep.cuh and the probe's forms of
// box_probe.cu over the engine's tables (tabs, dims, vals as make_geom
// takes them; bins, the 3 E doubles of the rate pass's parameters). kind
// 0: the gather of the n sources at pos into nhi (ceil(n_v / T_) x n
// blocks, thread after thread); 1: the engine's sweep of n sources from
// nhi into cdin, the ring in shared memory with `shared`, on `blocks`
// blocks of T_ threads (fewer than the sources: each block sweeps source
// after source), its rings in global memory at `ring` where not shared; 2:
// the engine's rate pass of n sources from nhi and cdin into the rated
// cells of the boxes phi (and heat), a pair a thread (thread after
// thread), the bins as parameters with `param`; 3: the trace loop of nb
// batches of B sources (box_trace of trace_loop.cu): a chunk's rate boxes
// zeroed, then per device batch of dev_batch sources the gather and the
// engine's sweep, per chunk of `chunk` batches the engine's rate pass (the
// bins as parameters where E <= kParamBins), per batch of B the
// accumulate over the rated cells (blocks of T_ threads) into phi_frame
// (and heat_frame); 4: the probe's sweep with `group` sources a thread
// (group_sweep_kernel), as kind 1; 5: the probe's rate pass on a grid of
// rate_blocks blocks (grid_rates_kernel), `unroll` bins a trip, as kind 2.
// The blocks and rows in reverse order with `reverse`. `io` holds frame,
// pos, flux, sdr3, nhi, ring, cdin, phi, heat, phi_frame, heat_frame (the
// heat channel's null without it). Returns 1 where a form is not one of
// the engine's or the probe's.
template <class T, class K>
void box_sweep_blocks(const box::Geom<T>& g, const box::SweepIO<T>& io,
                      K kern, int blocks, int T_, size_t smem, bool rev) {
  emu_blocks(blocks, 1, T_, smem, [&] { kern(g, io); }, rev);
}

template <class T>
int run_box(int kind, void* const* tabs, const int* dims, const double* vals,
            const double* bins, void* const* io, int n, int nb, int B,
            int dev_batch, int chunk, int T_, int group, int shared,
            int blocks, int param, int unroll, int rate_blocks,
            int reverse) {
  using P = const T*;
  const box::Geom<T> g = box::make_geom<T>(tabs, dims, vals);
  const box::Bins<T> bp = box::make_bins<T>(bins, g.E);
  const T* frame = (P)io[0];
  const int* pos = (const int*)io[1];
  const T* flux = (P)io[2];
  const T* sdr3 = (P)io[3];
  T* nhi = (T*)io[4];
  T* ring = (T*)io[5];
  T* cdin = (T*)io[6];
  T* phi = (T*)io[7];
  T* heat = (T*)io[8];
  const bool rev = reverse != 0;
  auto gather = [&](const int* p, int m) {
    emu_serial((g.n_v + T_ - 1) / T_, m, T_, [&] {
      box::sheet_gather_kernel<T>(g, frame, p, nhi);
    }, rev);
  };
  const size_t rb = box::ring_bytes(g);
  auto sweep = [&](int m) {
    const box::SweepIO<T> s{nhi, cdin, shared ? nullptr : ring, m};
    const int nbk = std::min(blocks, m);
    if (shared)
      box_sweep_blocks(g, s, box::sheet_sweep_kernel<T, true>, nbk, T_, rb,
                       rev);
    else
      box_sweep_blocks(g, s, box::sheet_sweep_kernel<T, false>, nbk, T_, 0,
                       rev);
  };
  auto group_sweep = [&](int m) {
    const box::SweepIO<T> s{nhi, cdin, shared ? nullptr : ring, m};
    const int nbk = std::min(blocks, (m + group - 1) / group);
    const size_t smem = shared ? rb * group : 0;
    using namespace box_probe;
#define BOX_GROUP(S, SH)                                                      \
  if (group == S && shared == SH) {                                           \
    box_sweep_blocks(g, s, group_sweep_kernel<T, S, SH, 0, 1>, nbk, T_, smem, \
                     rev);                                                    \
    return 0;                                                                 \
  }
    BOX_GROUP(1, false) BOX_GROUP(2, false) BOX_GROUP(4, false)
    BOX_GROUP(8, false) BOX_GROUP(1, true) BOX_GROUP(2, true)
#undef BOX_GROUP
    return 1;
  };
  // the engine's rate pass, a pair a thread
  auto rates = [&](const box::RateIO<T>& a, int m, bool par) {
    const int nbk = int((size_t(m) * g.n_r + T_ - 1) / T_);
    auto run = [&](auto kern) {
      emu_serial(nbk, 1, T_, [&] { kern(g, a, bp, m); }, rev);
    };
    const bool h = a.heat != nullptr;
    if (h && par) run(box::sheet_rates_kernel<T, true, true>);
    else if (h) run(box::sheet_rates_kernel<T, true, false>);
    else if (par) run(box::sheet_rates_kernel<T, false, true>);
    else run(box::sheet_rates_kernel<T, false, false>);
  };
  auto grid_rates = [&](const box::RateIO<T>& a, int m) {
    auto run = [&](auto kern) {
      emu_serial(rate_blocks, 1, T_, [&] { kern(g, a, bp, m); }, rev);
      return 0;
    };
    using namespace box_probe;
    const bool h = a.heat != nullptr;
    switch ((h ? 4 : 0) + (param ? 2 : 0) + (unroll == 2)) {
      case 0: return run(grid_rates_kernel<T, false, false, 1>);
      case 1: return run(grid_rates_kernel<T, false, false, 2>);
      case 2: return run(grid_rates_kernel<T, false, true, 1>);
      case 3: return run(grid_rates_kernel<T, false, true, 2>);
      case 4: return run(grid_rates_kernel<T, true, false, 1>);
      case 5: return run(grid_rates_kernel<T, true, false, 2>);
      case 6: return run(grid_rates_kernel<T, true, true, 1>);
      default: return run(grid_rates_kernel<T, true, true, 2>);
    }
  };
  const box::RateIO<T> all{nhi, cdin, flux, sdr3, phi, heat};
  switch (kind) {
    case 0: gather(pos, n); return 0;
    case 1: sweep(n); return 0;
    case 2: rates(all, n, param != 0); return 0;
    case 4: return group_sweep(n);
    case 5: return grid_rates(all, n);
    case 3: break;
    default: return 1;
  }
  const size_t D3 = size_t(g.Dc) * g.Dc * g.Dc;
  std::fill(phi, phi + size_t(chunk) * B * D3, T(0));
  if (heat) std::fill(heat, heat + size_t(chunk) * B * D3, T(0));
  void* frames[2] = {io[9], io[10]};
  const int ns = nb * B;
  for (int s = 0; s < ns; s += dev_batch) {
    const int m = std::min(dev_batch, ns - s);
    gather(pos + size_t(3) * s, m);
    sweep(m);
    for (int a = 0; a < m; a += chunk * B) {
      const int k = std::min(chunk * B, m - a);
      const size_t at = size_t(a) * g.n_v;
      rates(box::RateIO<T>{nhi + at, cdin + at, flux + s + a, sdr3, phi,
                           heat}, k, g.E <= box::kParamBins);
      for (int j = 0; j < k / B; ++j) {
        void* boxes[2] = {phi + size_t(j) * B * D3,
                          heat ? heat + size_t(j) * B * D3 : nullptr};
        run_boxes<T>(frames, boxes, heat ? 2 : 1, pos, (s + a) / B + j, B,
                     g.Dc, 0, g.P, g.P, g.P, g.rcell, g.visit, g.n_r, T_,
                     reverse);
      }
    }
  }
  return 0;
}

#define REHEARSE_BOX(NAME, TYPE)                                               \
  extern "C" int NAME(int kind, void* const* tabs, const int* dims,           \
                      const double* vals, const double* bins,                 \
                      void* const* io, int n, int nb, int B, int dev_batch,   \
                      int chunk, int T_, int group, int shared, int blocks,   \
                      int param, int unroll, int rate_blocks, int reverse) {  \
    return run_box<TYPE>(kind, tabs, dims, vals, bins, io, n, nb, B,          \
                         dev_batch, chunk, T_, group, shared, blocks, param,  \
                         unroll, rate_blocks, reverse);                       \
  }
REHEARSE_BOX(rehearse_box_f32, float)
REHEARSE_BOX(rehearse_box_f64, double)
