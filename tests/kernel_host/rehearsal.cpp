// Runs the port's sweep kernels on the host: k_sweep.inc and k_rates.inc are
// the device parts of cheb_sweep.cu and cheb_sweep_rates.cu as
// tests/test_torch_rehearsal.py cuts them out, compiled against the stand-in
// headers of this directory. One cluster (source) runs at a time, its
// C blocks x T threads as std::threads.
#include <thread>
#include <type_traits>
#include "cuda_runtime.h"
thread_local uint3_ threadIdx, blockIdx, blockDim;
thread_local EmuCluster* emu_cl;
thread_local int emu_rank;
#include "k_sweep.inc"
#include "k_rates.inc"
using namespace cheb;

template <class F>
void emu_launch(int B, int C, int T, size_t smem, F f) {
  for (int src = 0; src < B; ++src) {
    EmuCluster cl;
    cl.C = C; cl.T = T; cl.smem = smem;
    std::barrier<> cbar(C * T);
    cl.cluster_bar = &cbar;
    for (int k = 0; k < C; ++k) {
      cl.bufs.emplace_back(smem + 16, 0xee);
      cl.block_bar.push_back(new std::barrier<>(T));
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
          f();
        });
    for (auto& x : th) x.join();
    for (auto* p : cl.block_bar) delete p;
  }
}

// kind 0: K1, 1: K1f, 2: K2, 3: phase A of K3 (box = cdin, box2 = dcol).
// Returns 1 where make_plan refuses the caller's sizes.
template <class T>
int run(int kind, const void* nhi, const void* sw, const void* path,
        const void* diag, const void* mm, const void* mp, const void* rt,
        const void* bs, const void* bw, const void* pin, void* pout, void* box,
        void* box2, void* scratch, int B, int Dc, int c, int R1, int E, int r0,
        int r1, double dr, double sig, double R2, double sdr3, int threads,
        int C, int sh, int smem) {
  const Tables<T> tb = make_tables<T>(sw, path, diag, mm, mp, Dc, c, R1, dr, sig);
  const LaunchSpec spec{B, threads, C, sh, smem, nullptr, nullptr};
  Plan pl;
  if (make_plan<T>(spec, Dc, kind == 1 ? 2 * E : 0, &pl) != cudaSuccess)
    return 1;
  auto N = static_cast<const T*>(nhi);
  auto S = static_cast<T*>(scratch);
  auto call = [&](auto shared) {
    constexpr bool SH = decltype(shared)::value;
    emu_launch(B, C, threads, smem, [&] {
      if (kind == 0)
        cheb_sweep_kernel<T, SH>(tb, pl, N, (T*)box, S);
      else if (kind == 1)
        cheb_sweep_gamma_kernel<T, SH>(tb, pl, N, (const T*)rt, (const T*)bs,
                                       (const T*)bw, E, T(R2), T(sdr3),
                                       (T*)box, S);
      else if (kind == 2)
        cheb_sweep_seg_kernel<T, SH>(tb, pl, N, (const T*)pin, (T*)pout, r0, r1,
                                     (T*)box, S);
      else
        rates::sweep_fold_kernel<T, SH>(tb, pl, N, (T*)box, (T*)box2, S);
    });
  };
  if (sh) call(std::true_type{}); else call(std::false_type{});
  return 0;
}

#define REHEARSE(SFX, T)                                                       \
  extern "C" int rehearse_##SFX(                                               \
      int kind, const void* nhi, const void* sw, const void* path,            \
      const void* diag, const void* mm, const void* mp, const void* rt,       \
      const void* bs, const void* bw, const void* pin, void* pout, void* box, \
      void* box2, void* scratch, int B, int Dc, int c, int R1, int E, int r0, \
      int r1, double dr, double sig, double R2, double sdr3, int threads,     \
      int C, int sh, int smem) {                                               \
    return run<T>(kind, nhi, sw, path, diag, mm, mp, rt, bs, bw, pin, pout,   \
                  box, box2, scratch, B, Dc, c, R1, E, r0, r1, dr, sig, R2,   \
                  sdr3, threads, C, sh, smem);                                 \
  }
REHEARSE(f32, float)
REHEARSE(f64, double)
