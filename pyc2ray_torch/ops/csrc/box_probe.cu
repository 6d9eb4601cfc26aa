// The box engine's forms that were measured beside the engine's kernels,
// for chip_smoke.py's tables of the design steps alone (only chip_smoke.py
// builds this source; the engine's library, trace_loop.cu, holds the
// engine's kernels, box_sweep.cuh their device code).
//
//   the sweep      the first port's kernel (a source a block, every
//                  outgoing column density stored to an (n, n_v) array that
//                  is also its ring in the global placement, read by
//                  __ldcg), in both placements; S sources a thread
//                  (group_sweep_kernel: a cell's tables loaded once for the
//                  S sources, also two cells a trip, and with parts of the
//                  step taken out: kProbe*, the corners read past L1, which
//                  computes the function, and the tables read L1-hot or a
//                  multiply for each division, timed only); S sources a
//                  block, a thread each (lanes_sweep_kernel); the engine's
//                  kernel on a persistent grid.
//   the rate pass  the first port's kernel (a grid of the rated cells by
//                  the sources, the bins loaded from the tables), a
//                  persistent grid or a pair a thread (grid_rates_kernel),
//                  the bins as parameters or loaded, one or two bins a
//                  trip, and the engine's kernel.
//
// Each form that computes its kernel's function gives the plain version's
// bits.

#include "box_sweep.cuh"

namespace box_probe {

using namespace box;

// Parts of the sweep's step taken out (group_sweep_kernel's PROBE):
// kProbeRingCg computes the function (the corners read past L1, as the
// first port read them); the others do not and are timed only.
constexpr int kProbeNoDiv = 1;       // a multiply for each division
constexpr int kProbeHotTables = 2;   // a cell's tables read at v mod 1024
                                     // (L1-hot), its ring places clamped
constexpr int kProbeRingCg = 4;      // the corners read by __ldcg

template <typename T, int PROBE>
__device__ __forceinline__ T div_or_probe(T a, T b) {
  return (PROBE & kProbeNoDiv) ? mul(a, b) : div(a, b);
}

// A group of S values of type T as one aligned access: a thread's S
// sources' column densities at one cell of the ring.
template <typename T, int S>
struct alignas(sizeof(T) * S) Pack {
  T v[S];
};

// The largest block of group_sweep_kernel for S sources a thread: 64
// registers a thread at 1024 threads, 128 at 512, 255 at 256.
__host__ __device__ constexpr int group_max_threads(int S) {
  return S == 1 ? kMaxSweepThreads : (S == 2 ? 512 : 256);
}

// The bytes of a ring of S sources.
template <typename T>
size_t group_ring_bytes(const Geom<T>& g, int S) {
  return ring_bytes(g) * S;
}

// One trip of a thread of group_sweep_kernel: CELLS cells v, v + nt, ...
// of the shell (those past `end` not stored), each cell's tables and then
// its S sources' corners loaded before the first division, then each
// source's weights, incoming and outgoing column densities. from, into:
// the ring's places of the corners' shells and of this one, less their
// first cells' numbers.
template <typename T, int S, bool SHARED, int PROBE, int CELLS>
__device__ __forceinline__ void sweep_cells(const Geom<T>& g,
                                            const SweepIO<T>& io, T* ring,
                                            const size_t (&at)[S], int cnt,
                                            const int (&from)[4], int into,
                                            int v0, int end, int nt) {
  const T lim = static_cast<T>(0.6);
  const int span = kRingSlots * g.max_shell;     // ring places a source
  int v[CELLS], n[CELLS][4];
  T sw[CELLS][4], diag[CELLS], pdr[CELLS];
  Pack<T, S> c[CELLS][4];
#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
    v[j] = CELLS == 1 ? v0 : min(v0 + j * nt, end - 1);
    const int tv = (PROBE & kProbeHotTables) ? (v[j] & 1023) : v[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      n[j][k] = g.corner[size_t(k) * g.n_v + tv];
      sw[j][k] = g.sw[size_t(k) * g.n_v + tv];
    }
    diag[j] = g.diag[tv];
    pdr[j] = mul(g.path[tv], g.dr);
  }
#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int p = from[k] + n[j][k];
      if (PROBE & kProbeHotTables) p = min(max(p, 0), span - 1);
      const T* src = ring + size_t(p) * S;
      if (n[j][k] < 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) c[j][k].v[s] = T(0);
      } else if ((PROBE & kProbeRingCg) && !SHARED) {
#pragma unroll
        for (int s = 0; s < S; ++s) c[j][k].v[s] = __ldcg(src + s);
      } else {
        c[j][k] = *reinterpret_cast<const Pack<T, S>*>(src);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
    if (CELLS > 1 && v0 + j * nt >= end) break;
    Pack<T, S> out;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      T cw[4], w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = div_or_probe<T, PROBE>(
            sw[j][k], clamp_min(mul(c[j][k].v[s], g.sig), lim));
        cw[k] = mul(c[j][k].v[s], w[k]);
      }
      const T num = add(add(add(cw[0], cw[1]), cw[2]), cw[3]);
      const T den = add(add(add(w[0], w[1]), w[2]), w[3]);
      const T in = div_or_probe<T, PROBE>(mul(diag[j], num), den);
      out.v[s] = add(in, mul(io.nhi[at[s] + v[j]], pdr[j]));
      if (s < cnt) io.cdin[at[s] + v[j]] = in;
    }
    *reinterpret_cast<Pack<T, S>*>(ring + size_t(into + v[j]) * S) = out;
  }
}

// The sweep with S sources a thread (the design's step (b)): block k
// sweeps source groups k, k + gridDim.x, ... (a group: S consecutive
// sources; the last may hold fewer). A thread takes a cell of the shell,
// loads its tables once and then its S sources' corners, all before the
// first division, and applies them to each source of the group: S
// independent division chains. The group's ring as the engine's, a cell's
// S values side by side (one access), in shared memory (SHARED) or in
// global memory (io.ring: ring_bytes S a block). A source past the group's
// end repeats the group's last, whose cdin it does not store. CELLS: cells
// a trip of a thread, their loads all issued before the first division.
template <typename T, int S, bool SHARED, int PROBE, int CELLS>
__global__ void __launch_bounds__(group_max_threads(S))
group_sweep_kernel(Geom<T> g, SweepIO<T> io) {
  const int nt = blockDim.x, t = threadIdx.x;
  const int groups = (io.n + S - 1) / S;
  T* ring = SHARED ? ring_mem<T>()
                   : io.ring + size_t(blockIdx.x) * kRingSlots * g.max_shell *
                                   S;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int cnt = min(S, io.n - grp * S);
    size_t at[S];             // row of source s of the group
#pragma unroll
    for (int s = 0; s < S; ++s)
      at[s] = size_t(grp * S + min(s, cnt - 1)) * g.n_v;
    __syncthreads();          // the previous group's reads are done
    for (int v = g.shell[0] + t; v < g.shell[1]; v += nt) {
      Pack<T, S> out;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        out.v[s] = mul(io.nhi[at[s] + v], g.half_dr);
        if (s < cnt) io.cdin[at[s] + v] = T(0);
      }
      *reinterpret_cast<Pack<T, S>*>(ring + size_t(v - g.shell[0]) * S) = out;
    }
    for (int q = 1; q < g.Q; ++q) {
      __syncthreads();
      const int start = g.shell[q], end = g.shell[q + 1];
      int from[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int lag = k == 0 ? 3 : (k == 3 ? 1 : 2);
        const int q2 = q > lag ? q - lag : 0;
        from[k] = (q2 % kRingSlots) * g.max_shell - g.shell[q2];
      }
      const int into = (q % kRingSlots) * g.max_shell - start;
      for (int v = start + t; v < end; v += nt * CELLS)
        sweep_cells<T, S, SHARED, PROBE, CELLS>(g, io, ring, at, cnt, from,
                                                into, v, end, nt);
    }
  }
}

// The first port's sweep: block s sweeps source s into row s of cd (every
// outgoing column density) and cdin; RING: the last kRingSlots shells'
// outgoing column densities in shared memory as well, else read back from
// cd past L1.
template <typename T, bool RING>
__global__ void __launch_bounds__(kMaxSweepThreads)
first_sweep_kernel(Geom<T> g, const T* nhi, T* cd, T* cdin) {
  const size_t at = size_t(blockIdx.x) * g.n_v;
  const T* no = nhi + at;
  T* co = cd + at;
  T* ci = cdin + at;
  T* ring = RING ? ring_mem<T>() : nullptr;
  const int nt = blockDim.x, t = threadIdx.x;
  for (int v = g.shell[0] + t; v < g.shell[1]; v += nt) {
    const T out = mul(no[v], g.half_dr);
    co[v] = out;
    if (RING) ring[v - g.shell[0]] = out;
    ci[v] = T(0);
  }
  const T lim = static_cast<T>(0.6);
  for (int q = 1; q < g.Q; ++q) {
    __syncthreads();
    const int start = g.shell[q], end = g.shell[q + 1];
    int from[4] = {0, 0, 0, 0}, into = 0;
    if (RING) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int lag = k == 0 ? 3 : (k == 3 ? 1 : 2);
        const int q2 = q > lag ? q - lag : 0;
        from[k] = (q2 % kRingSlots) * g.max_shell - g.shell[q2];
      }
      into = (q % kRingSlots) * g.max_shell - start;
    }
    for (int v = start + t; v < end; v += nt) {
      T cw[4], w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = g.corner[size_t(k) * g.n_v + v];
        const T c = n < 0 ? T(0) : (RING ? ring[from[k] + n] : __ldcg(co + n));
        w[k] = div(g.sw[size_t(k) * g.n_v + v], clamp_min(mul(c, g.sig), lim));
        cw[k] = mul(c, w[k]);
      }
      const T num = add(add(add(cw[0], cw[1]), cw[2]), cw[3]);
      const T den = add(add(add(w[0], w[1]), w[2]), w[3]);
      const T in = div(mul(g.diag[v], num), den);
      const T out = add(in, mul(no[v], mul(g.path[v], g.dr)));
      ci[v] = in;
      if (RING) {
        ring[into + v] = out;
        co[v] = out;
      } else {
        __stcg(co + v, out);
      }
    }
  }
}

// The sweep with S sources a block, a thread each (measured as a form of
// the design's step (b)): block k sweeps groups k, k + gridDim.x, ... of S
// sources; thread t takes source t mod S and every (blockDim.x / S)-th cell
// from cell t / S on, so the S threads of a cell are neighbours in a warp
// and load its tables at the same addresses, one request for all S; the
// ring in global memory as the engine's (a cell's S values side by side).
template <typename T, int S>
__global__ void __launch_bounds__(kMaxSweepThreads)
lanes_sweep_kernel(Geom<T> g, SweepIO<T> io) {
  const int nt = blockDim.x / S, t = threadIdx.x / S, s = threadIdx.x % S;
  const int groups = (io.n + S - 1) / S;
  T* ring = io.ring + size_t(blockIdx.x) * kRingSlots * g.max_shell * S;
  const T lim = static_cast<T>(0.6);
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int cnt = min(S, io.n - grp * S);
    const bool mine = s < cnt;
    const size_t at = size_t(grp * S + min(s, cnt - 1)) * g.n_v;
    const T* nhi = io.nhi + at;
    T* cdin = io.cdin + at;
    __syncthreads();
    for (int v = g.shell[0] + t; v < g.shell[1]; v += nt) {
      ring[size_t(v - g.shell[0]) * S + s] = mul(nhi[v], g.half_dr);
      if (mine) cdin[v] = T(0);
    }
    for (int q = 1; q < g.Q; ++q) {
      __syncthreads();
      const int start = g.shell[q], end = g.shell[q + 1];
      int from[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int lag = k == 0 ? 3 : (k == 3 ? 1 : 2);
        const int q2 = q > lag ? q - lag : 0;
        from[k] = (q2 % kRingSlots) * g.max_shell - g.shell[q2];
      }
      const int into = (q % kRingSlots) * g.max_shell - start;
      for (int v = start + t; v < end; v += nt) {
        int n[4];
        T sw[4], c[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          n[k] = g.corner[size_t(k) * g.n_v + v];
          sw[k] = g.sw[size_t(k) * g.n_v + v];
        }
        const T diag = g.diag[v], pdr = mul(g.path[v], g.dr), nh = nhi[v];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          c[k] = n[k] < 0 ? T(0) : ring[size_t(from[k] + n[k]) * S + s];
        T cw[4], w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = div(sw[k], clamp_min(mul(c[k], g.sig), lim));
          cw[k] = mul(c[k], w[k]);
        }
        const T num = add(add(add(cw[0], cw[1]), cw[2]), cw[3]);
        const T den = add(add(add(w[0], w[1]), w[2]), w[3]);
        const T in = div(mul(diag, num), den);
        ring[size_t(into + v) * S + s] = add(in, mul(nh, pdr));
        if (mine) cdin[v] = in;
      }
    }
  }
}

// The first port's rate pass: thread (blockIdx.x, threadIdx.x) of row
// blockIdx.y takes rated cell r of source b = blockIdx.y, the bins loaded
// from the tables.
template <typename T, bool HEAT>
__global__ void __launch_bounds__(kThreads)
first_rates_kernel(Geom<T> g, RateIO<T> a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (r >= g.n_r) return;
  const int v = g.rv[r];
  const size_t k = size_t(b) * g.n_v + v;
  const T nhi = a.nhi[k], cin = a.cdin[k];
  const T tau_in = mul(cin, g.sig);
  const T dtau = mul(mul(nhi, mul(g.path[v], g.dr)), g.sig);
  const T prefact = mul(mul(a.flux[b], *a.sdr3), g.geominv[r]);
  T acc = T(0), acc_h = T(0);
  for (int e = 0; e < g.E; ++e) {
    const T se = g.bins_s[e];
    const T core = mul(exp_(mul(-tau_in, se)), -expm1_(mul(-dtau, se)));
    acc = add(acc, mul(g.bins_w[e], core));
    if (HEAT) acc_h = add(acc_h, mul(g.bins_wh[e], core));
  }
  const bool mask = cin <= static_cast<T>(box::kMaxColdensH);
  const T nhi_safe = clamp_min(nhi, tiny<T>());
  const size_t o = size_t(b) * g.Dc * g.Dc * g.Dc + g.rcell[r];
  a.phi[o] = mask ? div(mul(prefact, acc), nhi_safe) : T(0);
  if (HEAT) a.heat[o] = mask ? div(mul(prefact, acc_h), nhi_safe) : T(0);
}

// The rate pass on a grid of any size (the design's steps (a) and (c)):
// the pairs (source b, rated cell r) of n sources, pair b n_r + r, a
// thread's pairs gridDim.x blockDim.x apart (one a thread where the grid
// covers them; several on a persistent grid), each as the engine's
// sheet_rates_kernel computes it, the bin loop unrolled UNROLL times.
template <typename T, bool HEAT, bool PARAM, int UNROLL>
__global__ void __launch_bounds__(kThreads)
grid_rates_kernel(Geom<T> g, RateIO<T> a, Bins<T> bins, int n) {
  const int stride = gridDim.x * blockDim.x;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int b = i / g.n_r, r = i - b * g.n_r;
  const int db = stride / g.n_r, dr_ = stride - db * g.n_r;
  const size_t D3 = size_t(g.Dc) * g.Dc * g.Dc;
  const T sdr3 = *a.sdr3;
  for (; b < n; b += db, r += dr_) {
    if (r >= g.n_r) {
      r -= g.n_r;
      ++b;
      if (b >= n) break;
    }
    const int v = g.rv[r];
    const size_t k = size_t(b) * g.n_v + v;
    const T nhi = a.nhi[k], cin = a.cdin[k];
    const T tau_in = mul(cin, g.sig);
    const T dtau = mul(mul(nhi, mul(g.path[v], g.dr)), g.sig);
    const T prefact = mul(mul(a.flux[b], sdr3), g.geominv[r]);
    T acc = T(0), acc_h = T(0);
#pragma unroll (UNROLL)
    for (int e = 0; e < g.E; ++e) {
      const T se = PARAM ? bins.s[e] : g.bins_s[e];
      const T core = mul(exp_(mul(-tau_in, se)), -expm1_(mul(-dtau, se)));
      acc = add(acc, mul(PARAM ? bins.w[e] : g.bins_w[e], core));
      if (HEAT) acc_h = add(acc_h, mul(PARAM ? bins.wh[e] : g.bins_wh[e],
                                       core));
    }
    const bool mask = cin <= static_cast<T>(box::kMaxColdensH);
    const T nhi_safe = clamp_min(nhi, tiny<T>());
    const size_t o = size_t(b) * D3 + g.rcell[r];
    a.phi[o] = mask ? div(mul(prefact, acc), nhi_safe) : T(0);
    if (HEAT) a.heat[o] = mask ? div(mul(prefact, acc_h), nhi_safe) : T(0);
  }
}

// The launches of the probe's forms (host code).

// The sweep's probe forms: 0 and 1 the first port's kernel in the global
// and the shared placement (scratch: its (n, n_v) cd); 2, 3, 4
// group_sweep_kernel in the global placement with kProbeRingCg,
// kProbeHotTables, kProbeNoDiv (S = 1 or 4); 5 S sources a block, a thread
// each (lanes_sweep_kernel, S = 2, 4, 8); 6 group_sweep_kernel with two
// cells a trip (S = 1); 7 and 8 group_sweep_kernel with S sources a thread,
// the ring in global (S = 1, 2, 4, 8) or shared memory (S = 1, 2); 9 the
// engine's kernel, global (S = 1; a persistent grid where `blocks` is fewer
// than the sources). Scratch of forms 2-9: the rings of `blocks` blocks of
// S sources.
constexpr int kSweepProbeForms = 10;

// group_sweep_kernel in form (S, SHARED, PROBE, CELLS) on `blocks` blocks,
// or with `held` set the blocks of it the card holds.
template <typename T, int S, bool SHARED, int PROBE = 0, int CELLS = 1>
int launch_group(const Geom<T>& g, const SweepIO<T>& io, int threads,
                 int blocks, cudaStream_t st, int* held) {
  const auto kern = group_sweep_kernel<T, S, SHARED, PROBE, CELLS>;
  const size_t smem = SHARED ? group_ring_bytes(g, S) : 0;
  if (threads > group_max_threads(S) || smem > kMaxSmem ||
      (!held && !SHARED && io.ring == nullptr))
    return cudaErrorInvalidValue;
  if (held) return resident(reinterpret_cast<const void*>(kern), threads,
                            smem, held);
  if (SHARED) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<blocks, threads, smem, st>>>(g, io);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_lanes(const Geom<T>& g, const SweepIO<T>& io, int threads,
                 int blocks, cudaStream_t st, int* held) {
  const void* kern = reinterpret_cast<const void*>(lanes_sweep_kernel<T, S>);
  if (threads > kMaxSweepThreads) return cudaErrorInvalidValue;
  if (held) return resident(kern, threads, 0, held);
  lanes_sweep_kernel<T, S><<<blocks, threads, 0, st>>>(g, io);
  return static_cast<int>(cudaGetLastError());
}

// Form `form` of the sweep of n sources (a group of `group` sources), or
// with `held` set the blocks of it the card holds.
template <typename T>
int sweep_probe(int form, const Geom<T>& g, const T* nhi, T* cdin, T* scratch,
                int n, int threads, int group, int blocks, cudaStream_t st,
                int* held) {
  if (threads < 32 || threads % 32 != 0 || form < 0 ||
      form >= kSweepProbeForms || blocks < 1)
    return cudaErrorInvalidValue;
  if (form < 2) {
    const bool ring = form == 1;
    const size_t smem = ring ? ring_bytes(g) : 0;
    const void* kern = ring
        ? reinterpret_cast<const void*>(first_sweep_kernel<T, true>)
        : reinterpret_cast<const void*>(first_sweep_kernel<T, false>);
    if (threads > kMaxSweepThreads || smem > kMaxSmem)
      return cudaErrorInvalidValue;
    if (held) return resident(kern, threads, smem, held);
    if (ring) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      first_sweep_kernel<T, true><<<n, threads, smem, st>>>(g, nhi, scratch,
                                                            cdin);
    } else {
      first_sweep_kernel<T, false><<<n, threads, 0, st>>>(g, nhi, scratch,
                                                          cdin);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const SweepIO<T> io{nhi, cdin, scratch, n};
  const int groups = (n + group - 1) / group;
  blocks = blocks < groups ? blocks : groups;
  if (form == 9) {
    if (group != 1) return cudaErrorInvalidValue;
    if (held) return sweep_resident<T, false>(g, threads, held);
    return launch_sweep<T, false>(g, io, threads, blocks, st);
  }
  if (form == 5) {
    if (group == 2) return launch_lanes<T, 2>(g, io, threads, blocks, st, held);
    if (group == 4) return launch_lanes<T, 4>(g, io, threads, blocks, st, held);
    if (group == 8) return launch_lanes<T, 8>(g, io, threads, blocks, st, held);
    return cudaErrorInvalidValue;
  }
#define BOX_GROUP_CASE(F, S, SH, P, C)                                        \
  if (form == F && group == S)                                                \
    return launch_group<T, S, SH, P, C>(g, io, threads, blocks, st, held);
  BOX_GROUP_CASE(2, 1, false, kProbeRingCg, 1)
  BOX_GROUP_CASE(2, 4, false, kProbeRingCg, 1)
  BOX_GROUP_CASE(3, 1, false, kProbeHotTables, 1)
  BOX_GROUP_CASE(3, 4, false, kProbeHotTables, 1)
  BOX_GROUP_CASE(4, 1, false, kProbeNoDiv, 1)
  BOX_GROUP_CASE(4, 4, false, kProbeNoDiv, 1)
  BOX_GROUP_CASE(6, 1, false, 0, 2)
  BOX_GROUP_CASE(7, 1, false, 0, 1)
  BOX_GROUP_CASE(7, 2, false, 0, 1)
  BOX_GROUP_CASE(7, 4, false, 0, 1)
  BOX_GROUP_CASE(7, 8, false, 0, 1)
  BOX_GROUP_CASE(8, 1, true, 0, 1)
  BOX_GROUP_CASE(8, 2, true, 0, 1)
#undef BOX_GROUP_CASE
  return cudaErrorInvalidValue;
}

// The blocks of grid_rates_kernel in form (HEAT, PARAM, UNROLL) the card
// holds at once (asked once a device), into `held`.
template <typename T, bool HEAT, bool PARAM, int UNROLL>
int rates_held(int* held) {
  static int held_on[64] = {};
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidValue;
  if (held_on[dev] == 0) {
    const auto kern = grid_rates_kernel<T, HEAT, PARAM, UNROLL>;
    const int err = resident(reinterpret_cast<const void*>(kern), kThreads,
                             0, &held_on[dev]);
    if (err != cudaSuccess) return err;
  }
  *held = held_on[dev];
  return cudaSuccess;
}

// grid_rates_kernel in form (HEAT, PARAM, UNROLL) on `blocks` blocks (0: a
// pair a thread), or on a persistent grid of the blocks the card holds at
// once with `persistent`.
template <typename T, bool HEAT, bool PARAM, int UNROLL>
int launch_grid_rates(const Geom<T>& g, const RateIO<T>& a,
                      const Bins<T>& bins, int n, bool persistent,
                      cudaStream_t st) {
  if (PARAM && g.E > kParamBins) return cudaErrorInvalidValue;
  const long long need = (static_cast<long long>(n) * g.n_r + kThreads - 1) /
                         kThreads;
  int blocks = static_cast<int>(need);
  if (persistent) {
    int held = 0;
    const int err = rates_held<T, HEAT, PARAM, UNROLL>(&held);
    if (err != cudaSuccess) return err;
    if (held < blocks) blocks = held;
  }
  grid_rates_kernel<T, HEAT, PARAM, UNROLL><<<blocks, kThreads, 0, st>>>(
      g, a, bins, n);
  return static_cast<int>(cudaGetLastError());
}

// The rate pass's forms: 0 the first port's kernel; 1 to 4 the persistent
// grid with the bins loaded (1, 2) or as parameters (3, 4), one (1, 3) or
// two (2, 4) bins a trip; 5 the engine's kernel (a pair a thread, the bins
// as parameters, two a trip); 6 a pair a thread with the bins as
// parameters, one a trip.
template <typename T, bool HEAT>
int rates_probe_heat(int form, const Geom<T>& g, const RateIO<T>& a,
                     const Bins<T>& bins, int n, cudaStream_t st) {
  switch (form) {
    case 0: {
      const dim3 grid((g.n_r + kThreads - 1) / kThreads, n);
      first_rates_kernel<T, HEAT><<<grid, kThreads, 0, st>>>(g, a);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return launch_grid_rates<T, HEAT, false, 1>(g, a, bins, n, true,
                                                        st);
    case 2: return launch_grid_rates<T, HEAT, false, 2>(g, a, bins, n, true,
                                                        st);
    case 3: return launch_grid_rates<T, HEAT, true, 1>(g, a, bins, n, true,
                                                       st);
    case 4: return launch_grid_rates<T, HEAT, true, 2>(g, a, bins, n, true,
                                                       st);
    case 5: return g.E <= kParamBins ? launch_rates<T>(g, a, bins, n, st)
                                     : cudaErrorInvalidValue;
    case 6: return launch_grid_rates<T, HEAT, true, 1>(g, a, bins, n, false,
                                                       st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace box_probe

extern "C" {

// Form `form` of the sweep (box_probe::sweep_probe) of the n sources whose
// nHI is nhi (n, n_v) into cdin, with `scratch` its column densities' store
// (forms 0, 1: (n, n_v); the others: the rings of `blocks` blocks of
// `group` sources), in blocks of `threads` threads.
#define BOX_PROBE_ENTRIES(SFX, TYPE)                                           \
  int box_sweep_probe_##SFX(int form, void* const* tabs, const int* dims,     \
                            const double* vals, const void* nhi, void* cdin,   \
                            void* scratch, int n, int threads, int group,      \
                            int blocks, void* stream) {                        \
    const box::Geom<TYPE> g = box::make_geom<TYPE>(tabs, dims, vals);          \
    if (!box::fits(g, n, false)) return cudaErrorInvalidValue;                 \
    return box_probe::sweep_probe<TYPE>(                                       \
        form, g, static_cast<const TYPE*>(nhi), static_cast<TYPE*>(cdin),      \
        static_cast<TYPE*>(scratch), n, threads, group, blocks,                \
        static_cast<cudaStream_t>(stream), nullptr);                           \
  }                                                                            \
  int box_probe_resident_##SFX(int form, void* const* tabs, const int* dims,  \
                               const double* vals, int threads, int group,     \
                               int* held) {                                    \
    const box::Geom<TYPE> g = box::make_geom<TYPE>(tabs, dims, vals);          \
    if (!box::fits(g, 1, false)) return cudaErrorInvalidValue;                 \
    return box_probe::sweep_probe<TYPE>(form, g, nullptr, nullptr, nullptr,    \
                                        1, threads, group, 1, nullptr, held);  \
  }                                                                            \
  int box_rates_probe_##SFX(int form, void* const* tabs, const int* dims,     \
                            const double* vals, const double* bins,            \
                            const void* nhi, const void* cdin,                 \
                            const void* flux, const void* sdr3, void* phi,     \
                            void* heat, int n, void* stream) {                 \
    const box::Geom<TYPE> g = box::make_geom<TYPE>(tabs, dims, vals);          \
    if (!box::fits(g, n, heat != nullptr) || !box::rates_fit(g, n))            \
      return cudaErrorInvalidValue;                                            \
    using P = const TYPE*;                                                     \
    const box::RateIO<TYPE> a{static_cast<P>(nhi), static_cast<P>(cdin),       \
                              static_cast<P>(flux), static_cast<P>(sdr3),      \
                              static_cast<TYPE*>(phi),                         \
                              static_cast<TYPE*>(heat)};                       \
    const box::Bins<TYPE> b = box::make_bins<TYPE>(bins, g.E);                 \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    return heat ? box_probe::rates_probe_heat<TYPE, true>(form, g, a, b, n, st)\
                : box_probe::rates_probe_heat<TYPE, false>(form, g, a, b, n,   \
                                                           st);                \
  }

BOX_PROBE_ENTRIES(f32, float)
BOX_PROBE_ENTRIES(f64, double)

#undef BOX_PROBE_ENTRIES

const char* box_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
