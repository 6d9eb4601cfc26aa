// The three-species (HI, HeI, HeII) spectral-bin rate pass of the helium
// engine for NVIDIA Hopper (sm_90a): per rated cell of the central rates
// subbox of B boxes, the photoionization rate of each species (and, with
// HEAT, the photoheating rate per HI atom) from the three species'
// coldensh_out boxes of K1 or K2 and their absorber boxes. Shared by
// cheb_rates.cu (one call per batch) and trace_loop.cu (the helium batch
// loop of a whole trace).
//
// Counterpart of pyc2ray_tpu/ops/raytrace_he.py::HeRaytracer._rates_he (no
// TPU kernel: XLA code there, two (cells, 3) x (3, E) einsums, an
// exp/expm1 block over (cells, E) and two (cells, E) x (E, 3) einsums).
// Plain version: pyc2ray_torch/ops/cheb_rates.py::rates_he_ref, op by op.
// Per cell of the (Ds)^3 subbox at box offset rb0 (channels of the table
// rt: path3, geominv, valid), species s = HI, HeI, HeII and bin e (se, w_se
// and wh_se are the engine's (3, E) tables: sigma_s(nu_e), w_e sigma_s(nu_e)
// and w_heat[s, e] sigma_s(nu_e)):
//   dcol_s = n_s (path3 dr),  cdin_s = cd_s - dcol_s
//   tau_e  = sum_s cdin_s se[s, e],  dtau_e = sum_s dcol_s se[s, e]
//   inv_e  = e^{-tau_e} (-expm1(-dtau_e)) / max(dtau_e, tiny)
//   G_s    = (flux S*/dr^3) geominv dcol_s sum_e inv_e w_se[s, e]
//            / max(n_s, tiny)
//   heat   = (flux S*/dr^3) geominv sum_s dcol_s sum_e inv_e wh_se[s, e]
//            / max(n_HI, tiny)                                  (HEAT only)
// G_s is 0 where the cell is not valid, where cdin_HI > 2e30 or where
// n_s <= 0; the heat where G_HI is. tiny is 1e-30 in float32 and 1e-280 in
// float64, the JAX engine's. cdin is rebuilt as cd - dcol as the JAX engine
// does, with its float32 cancellation at thick cells (ROADMAP §3): the
// plain version must stay the JAX package's twin.
//
// Design. One thread per rated cell of every box, B n_valid threads in
// 256-thread blocks over the engine's list of the subbox's rated cells
// (ops/cheb_rates.py::rated_cells); a cell that is not listed is never
// written, its outputs stay at the 0 the caller zeroed. Per cell the three
// column densities and densities are loaded once and the sums stay in
// registers. What a bin costs is its instructions: libdevice's expf,
// expm1f and IEEE division take ~35 of them, and every bin ran all three
// species in tau, dtau and the sums. So:
//  - Bins by band. A species has no term at a bin where its se, w_se and
//    (HEAT) wh_se are all 0: its products there are c 0 with c finite, and
//    adding them leaves every sum's bits as they are. From the first bin at
//    which a species has a non-zero entry on, it is in every bin's terms.
//    The bins then run in up to three bands, with 1, 2 and 3 species'
//    terms (the default 72-bin table: HI from bin 0, HeI from 24, HeII
//    from 48). Bins before every species' first are left out. The engine
//    finds the bands in its tables once, on the host
//    (ops/cheb_rates.py::he_bands), and passes them with the records.
//  - One record a bin: the se, then the w_se and (HEAT) the wh_se of the
//    band's species side by side, padded to whole 16-byte vectors, so a
//    bin takes one to three vector loads. The engine packs the records
//    once; each block copies them into its shared memory, which holds
//    nothing else: 1.5 KB at the default table in float32, up to the 227
//    KB a block can ask for (beyond 48 KB the launch asks).
//  - kHeUnroll bins in flight a thread: each bin's exp, expm1 and division
//    are independent; the sums take them strictly in bin order. A band's
//    bins are padded to a multiple of kHeUnroll with records of zeros,
//    whose every term is a signed zero added to a sum that is not -0.
//    Two, the fastest of 1, 2 and 4 in the helium trace's loop (PERF.md):
//    45 registers a thread in float32 (55 with HEAT), five blocks to an SM
//    (four).
// Every operation is an explicitly rounded intrinsic in the plain
// version's type and order (the species sums in the order HI, HeI, HeII
// over the band's species, no FMA contraction), the scalars dr and S*/dr^3
// rounded to the type once by the caller, so the pass is bit-equal to the
// plain one on the card. Index arithmetic is 32-bit (the caller keeps B
// (Ds)^3 below 2^31).
//
// Bound. It reads the list, path3 and geominv at the listed cells, the six
// boxes at the listed cells of every box, the fluxes and the records once,
// and writes the 3-4 rates at the listed cells. At the bench shape (B = 8,
// Ds = Dc = 64, 72 bins, float32, 43% of the subbox rated) that is ~34 MB,
// 10 us at 3.35 TB/s. Its transcendentals bound it more: one exp, one
// expm1 and one reciprocal a bin of a rated cell on the MUFU pipe, ~47 us
// (chip_smoke prints the bound beside the time its own SASS takes at the
// issue rate).

#pragma once

#include "cheb_sweep.cuh"

namespace cheb {

constexpr int kHeSpecies = 3;      // HI, HeI, HeII
constexpr int kHeThreads = 256;    // threads per block of the pass
constexpr int kHeUnroll = 2;       // bins in flight a thread

// tiny of the helium rate pass (the JAX engine's): the floor of dtau and
// of the densities it divides by.
template <typename T> struct HeTiny;
template <> struct HeTiny<float> { static constexpr float v = 1e-30f; };
template <> struct HeTiny<double> { static constexpr double v = 1e-280; };

// A 16-byte vector of T.
template <typename T> struct HeVec;
template <> struct HeVec<float> {
  using V = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void put(const V& v, float* r) {
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
};
template <> struct HeVec<double> {
  using V = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ void put(const V& v, double* r) {
    r[0] = v.x; r[1] = v.y;
  }
};

// Values of a bin's record in a band of K species: se, w_se and (HEAT)
// wh_se of each, padded to whole 16-byte vectors.
template <typename T, int K, bool HEAT>
__host__ __device__ constexpr int he_record() {
  return ((HEAT ? 3 : 2) * K + HeVec<T>::n - 1) / HeVec<T>::n * HeVec<T>::n;
}

// The bands of a bin table, as ops/cheb_rates.py::he_bands packs them into
// kHeHead ints: whether the records hold wh_se, the records' values in all
// (T), then per band j (0, 1, 2: 1, 2, 3 species' terms) its passes of
// kHeUnroll records, the offset of its first record (values of T from the
// records' start) and its j + 1 species in ascending order (3 slots).
constexpr int kHeHead = 2 + 5 * kHeSpecies;
struct HeBands {
  int heat, n_rec;
  int iters[kHeSpecies], off[kHeSpecies];
  int sp[kHeSpecies * kHeSpecies];
};

// The bands of the header `h` (kHeHead ints on the host); no header gives
// bands he_rates_fit refuses.
inline HeBands he_bands_of(const int* h) {
  HeBands b{};
  if (h == nullptr) {
    b.n_rec = -1;
    return b;
  }
  b.heat = h[0];
  b.n_rec = h[1];
  for (int j = 0; j < kHeSpecies; ++j) {
    b.iters[j] = h[2 + j];
    b.off[j] = h[2 + kHeSpecies + j];
  }
  for (int i = 0; i < kHeSpecies * kHeSpecies; ++i)
    b.sp[i] = h[2 + 2 * kHeSpecies + i];
  return b;
}

// One call of the pass: three species' boxes in, the 3-4 rate subboxes out,
// written at the n_valid listed cells only.
template <typename T>
struct HeRates {
  const T* cd[kHeSpecies];    // (B, Dc, Dc, Dc) coldensh_out boxes
  const T* n[kHeSpecies];     // (B, Dc, Dc, Dc) absorber boxes
  const T* rt;                // (3, Ds, Ds, Ds): path3, geominv, valid
  const int* cells;           // (n_valid,) the rated cells, ascending
  const T* flux;              // (B,)
  const T* rec;               // (bands.n_rec,) the bins' records by band
  HeBands bands;
  T* out[kHeSpecies + 1];     // (B, Ds, Ds, Ds) each: G_HI, G_HeI, G_HeII
                              // and (HEAT) the heat; 0 at every cell not
                              // listed
  int B, Dc, Ds, rb0, n_valid;
  T dr, sdr3;                 // sdr3 = S* / dr^3
};

// v[sp] of a three-species register array, sp not a constant.
template <typename T>
__device__ __forceinline__ T he_pick(const T* v, int sp) {
  return sp == 0 ? v[0] : (sp == 1 ? v[1] : v[2]);
}
template <typename T>
__device__ __forceinline__ void he_put(T* v, int sp, T x) {
  if (sp == 0) v[0] = x;
  else if (sp == 1) v[1] = x;
  else v[2] = x;
}

// The bins of band K - 1 of `b` (K species' terms) into the sums acc and
// (HEAT) acc_h of the cell with column densities cdin and dcol, from the
// records `rec`: its passes of kHeUnroll bins.
template <typename T, bool HEAT, int K>
__device__ __forceinline__ void he_band(const T* rec, const HeBands& b,
                                        const T* cdin, const T* dcol, T* acc,
                                        T* acc_h) {
  using A = Arith<T>;
  using Vec = HeVec<T>;
  constexpr int S = he_record<T, K, HEAT>();
  const int iters = b.iters[K - 1];
  const int* sp = b.sp + kHeSpecies * (K - 1);
  rec += b.off[K - 1];
  T c[K], d[K], a[K], ah[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    c[i] = he_pick(cdin, sp[i]);
    d[i] = he_pick(dcol, sp[i]);
    a[i] = he_pick(acc, sp[i]);
    ah[i] = HEAT ? he_pick(acc_h, sp[i]) : T(0);
  }
  for (int it = 0; it < iters; ++it) {
    T inv[kHeUnroll], r[kHeUnroll][S];
#pragma unroll
    for (int u = 0; u < kHeUnroll; ++u) {
      const typename Vec::V* v = reinterpret_cast<const typename Vec::V*>(
          rec + (it * kHeUnroll + u) * S);
#pragma unroll
      for (int q = 0; q < S / Vec::n; ++q) Vec::put(v[q], r[u] + q * Vec::n);
      T tau = A::mul(c[0], r[u][0]);
      T dtau = A::mul(d[0], r[u][0]);
#pragma unroll
      for (int i = 1; i < K; ++i) {
        tau = A::add(tau, A::mul(c[i], r[u][i]));
        dtau = A::add(dtau, A::mul(d[i], r[u][i]));
      }
      const T core = A::mul(A::exp(-tau), -A::expm1(-dtau));
      inv[u] = A::div(core, max_lim(HeTiny<T>::v, dtau));
    }
#pragma unroll
    for (int u = 0; u < kHeUnroll; ++u)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        a[i] = A::add(a[i], A::mul(inv[u], r[u][K + i]));
        if (HEAT) ah[i] = A::add(ah[i], A::mul(inv[u], r[u][2 * K + i]));
      }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    he_put(acc, sp[i], a[i]);
    if (HEAT) he_put(acc_h, sp[i], ah[i]);
  }
}

template <typename T, bool HEAT>
__global__ void rates_he_kernel(HeRates<T> k) {
  using A = Arith<T>;
  using V = typename HeVec<T>::V;
  T* rec = shared_mem<T>();
  for (int i = threadIdx.x; i < k.bands.n_rec / HeVec<T>::n; i += blockDim.x)
    reinterpret_cast<V*>(rec)[i] = reinterpret_cast<const V*>(k.rec)[i];
  __syncthreads();
  const unsigned S = unsigned(k.Ds), S2 = S * S, S3 = S2 * S;
  const unsigned nv = unsigned(k.n_valid);
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= unsigned(k.B) * nv) return;
  const unsigned b = idx / nv, cell = unsigned(k.cells[idx - b * nv]);
  const unsigned i = cell / S2, jk = cell - i * S2, j = jk / S, l = jk - j * S;
  const size_t D = size_t(k.Dc), r = size_t(k.rb0);
  const size_t o = ((b * D + i + r) * D + j + r) * D + l + r;
  const T path = A::mul(k.rt[cell], k.dr);
  T n[kHeSpecies], dcol[kHeSpecies], cdin[kHeSpecies];
#pragma unroll
  for (int s = 0; s < kHeSpecies; ++s) {
    n[s] = k.n[s][o];
    dcol[s] = A::mul(n[s], path);
    cdin[s] = A::add(k.cd[s][o], -dcol[s]);
  }
  T out[kHeSpecies + 1] = {T(0), T(0), T(0), T(0)};
  if (cdin[0] <= T(kMaxColdensH)) {
    T acc[kHeSpecies] = {T(0), T(0), T(0)};
    T acc_h[kHeSpecies] = {T(0), T(0), T(0)};
    he_band<T, HEAT, 1>(rec, k.bands, cdin, dcol, acc, acc_h);
    he_band<T, HEAT, 2>(rec, k.bands, cdin, dcol, acc, acc_h);
    he_band<T, HEAT, 3>(rec, k.bands, cdin, dcol, acc, acc_h);
    const T pref = A::mul(A::mul(k.flux[b], k.sdr3), k.rt[S3 + cell]);
#pragma unroll
    for (int s = 0; s < kHeSpecies; ++s)
      if (n[s] > T(0))
        out[s] = A::div(A::mul(pref, A::mul(dcol[s], acc[s])),
                        max_lim(HeTiny<T>::v, n[s]));
    if (HEAT && n[0] > T(0)) {
      T h = A::mul(dcol[0], acc_h[0]);
#pragma unroll
      for (int s = 1; s < kHeSpecies; ++s)
        h = A::add(h, A::mul(dcol[s], acc_h[s]));
      out[kHeSpecies] = A::div(A::mul(pref, h), max_lim(HeTiny<T>::v, n[0]));
    }
  }
  const size_t w = size_t(b) * S3 + cell;
#pragma unroll
  for (int s = 0; s < kHeSpecies; ++s) k.out[s][w] = out[s];
  if (HEAT) k.out[kHeSpecies][w] = out[kHeSpecies];
}

// The dynamic shared memory of the pass: the records.
template <typename T>
size_t he_rates_smem(const HeRates<T>& k) {
  return size_t(k.bands.n_rec < 0 ? 0 : k.bands.n_rec) * sizeof(T);
}

// The shared memory a block of the pass may ask for on the card.
constexpr size_t kHeMaxSmem = size_t(227) << 10;

// Whether bands `b` lie within their records: every band's passes inside
// n_rec values of whole 16-byte vectors, its species 0 to 2.
template <typename T, bool HEAT>
bool he_bands_fit(const HeBands& b) {
  constexpr int stride[kHeSpecies] = {he_record<T, 1, HEAT>(),
                                      he_record<T, 2, HEAT>(),
                                      he_record<T, 3, HEAT>()};
  bool ok = b.n_rec >= 0 && b.n_rec % HeVec<T>::n == 0;
  for (int j = 0; j < kHeSpecies; ++j) {
    ok = ok && b.iters[j] >= 0 && b.off[j] >= 0 &&
         b.off[j] % HeVec<T>::n == 0 &&
         size_t(b.off[j]) + size_t(b.iters[j]) * kHeUnroll * stride[j] <=
             size_t(b.n_rec);
    for (int i = 0; i <= j; ++i)
      ok = ok && b.sp[kHeSpecies * j + i] >= 0 &&
           b.sp[kHeSpecies * j + i] < kHeSpecies;
  }
  return ok;
}

// Whether the sizes of `k` are ones the pass takes: a subbox inside the
// box, at most Ds^3 listed cells, B (Ds)^3 below 2^31, records with the
// heat channel's table where it has an output and not where it has none,
// bands within their records, and records within the shared memory a
// block may ask for.
template <typename T>
bool he_rates_fit(const HeRates<T>& k) {
  const bool heat = k.out[kHeSpecies] != nullptr;
  const size_t S3 = size_t(k.Ds) * k.Ds * k.Ds;
  return k.B >= 1 && k.Ds >= 1 && k.rb0 >= 0 && k.rb0 + k.Ds <= k.Dc &&
         k.n_valid >= 0 && size_t(k.n_valid) <= S3 &&
         size_t(k.B) * S3 < (size_t(1) << 31) &&
         (k.n_valid == 0 || k.cells != nullptr) &&
         (k.bands.heat != 0) == heat &&
         (heat ? he_bands_fit<T, true>(k.bands)
               : he_bands_fit<T, false>(k.bands)) &&
         (k.bands.n_rec == 0 || k.rec != nullptr) &&
         he_rates_smem(k) <= kHeMaxSmem;
}

// The launch of the helium pass on `st` (the HEAT form where k.out has the
// heat's) of sizes he_rates_fit has taken; returns the cudaError_t of the
// launch. No rated cell: no launch.
template <typename T>
int issue_rates_he(const HeRates<T>& k, cudaStream_t st) {
  const size_t n = size_t(k.B) * k.n_valid;
  if (n == 0) return cudaSuccess;
  void (*kernel)(HeRates<T>) = k.out[kHeSpecies] != nullptr
                                   ? rates_he_kernel<T, true>
                                   : rates_he_kernel<T, false>;
  const unsigned blocks = unsigned((n + kHeThreads - 1) / kHeThreads);
  const size_t smem = he_rates_smem(k);
  if (smem > (size_t(48) << 10)) {
    const cudaError_t err =
        allow(reinterpret_cast<const void*>(kernel), int(smem), false);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kHeThreads, smem, st>>>(k);
  return static_cast<int>(cudaGetLastError());
}

// The launch of the helium pass on `st` after he_rates_fit.
template <typename T>
int launch_rates_he(const HeRates<T>& k, cudaStream_t st) {
  if (!he_rates_fit(k)) return cudaErrorInvalidValue;
  return issue_rates_he(k, st);
}

}  // namespace cheb
