// Host stand-in for the CUDA device environment, for rehearsing the port's
// kernels on the CPU (tests/rehearsal_host.py): every thread of every
// block of a cluster is a std::thread, __syncthreads() a barrier of the
// block's threads, the cluster barrier a split barrier of all the cluster's
// threads (arrive and wait apart, as on the card, so a block's rate threads
// run beside its chain threads), and dynamic shared memory a buffer per block.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <optional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct uint3_ { unsigned x, y, z; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
extern thread_local uint3_ threadIdx, blockIdx, blockDim, gridDim;
struct EmuCluster {
  int C, T; size_t smem;
  std::vector<std::vector<unsigned char>> bufs;    // per block
  std::vector<std::barrier<>*> block_bar;
  std::barrier<>* cluster_bar;
  // per block and warp (32 threads, the last one the block's rest): a
  // barrier of the warp's threads and the ballot they fill
  std::vector<std::vector<std::barrier<>*>> warp_bar;
  std::vector<std::vector<unsigned>> ballot;
};
extern thread_local EmuCluster* emu_cl;
extern thread_local int emu_rank;
inline unsigned char* emu_smem() { return emu_cl->bufs[emu_rank].data(); }
inline void __syncthreads() { emu_cl->block_bar[emu_rank]->arrive_and_wait(); }
inline void __syncwarp() {}
// every thread of the warp calls it with the full mask, as the kernels do
inline unsigned __ballot_sync(unsigned, bool pred) {
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::barrier<>& bar = *emu_cl->warp_bar[emu_rank][w];
  std::atomic_ref<unsigned> acc(emu_cl->ballot[emu_rank][w]);
  bar.arrive_and_wait();
  if (pred) acc.fetch_or(1u << lane);
  bar.arrive_and_wait();
  const unsigned r = acc.load();
  bar.arrive_and_wait();
  if (lane == 0) acc.store(0u);
  return r;
}
// every thread of the warp calls it with the full mask, as the kernels do
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::barrier<>& bar = *emu_cl->warp_bar[emu_rank][w];
  std::atomic_ref<unsigned> acc(emu_cl->ballot[emu_rank][w]);
  bar.arrive_and_wait();
  acc.fetch_add(v);
  bar.arrive_and_wait();
  const unsigned r = acc.load();
  bar.arrive_and_wait();
  if (lane == 0) acc.store(0u);
  return r;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return unsigned((uint64_t(a) * b) >> 32);
}
// the split barrier: arrive returns at once, wait blocks until every thread
// of the cluster has arrived
extern thread_local std::optional<std::barrier<>::arrival_token> emu_token;
inline void emu_cluster_arrive() { emu_token.emplace(emu_cl->cluster_bar->arrive()); }
inline void emu_cluster_wait() {
  emu_cl->cluster_bar->wait(std::move(*emu_token));
  emu_token.reset();
}
using std::min; using std::max;
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
// add.rn.ftz.f32: a subnormal input or result is flushed to a zero of its
// sign
inline float emu_ftz(float x) {
  return std::fpclassify(x) == FP_SUBNORMAL ? std::copysign(0.0f, x) : x;
}
inline float emu_add_ftz_f32(float a, float b) {
  return emu_ftz(emu_ftz(a) + emu_ftz(b));
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline float atomicAdd(float* p, float v) {
  return std::atomic_ref<float>(*p).fetch_add(v);
}
inline double atomicAdd(double* p, double v) {
  return std::atomic_ref<double>(*p).fetch_add(v);
}
// cp.async's shared address: the copy itself is a memcpy on the host
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
template <class T> inline T __ldcg(const T* p) { return *(const volatile T*)p; }
template <class T> inline void __stcg(T* p, T v) { *(volatile T*)p = v; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
// the thermal update's intrinsics (csrc/thermal.cuh): fused multiply-adds,
// correctly rounded reciprocals, bit casts and conversions; rsqrtf and
// rsqrt as 1 / sqrt (the card's differ by an ulp here and there)
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline double __drcp_rn(double a) { return 1.0 / a; }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline double rsqrt(double a) { return 1.0 / std::sqrt(a); }
inline float __int_as_float(int v) { float f; std::memcpy(&f, &v, 4); return f; }
inline int __float_as_int(float f) { int v; std::memcpy(&v, &f, 4); return v; }
inline double __longlong_as_double(long long v) {
  double d; std::memcpy(&d, &v, 8); return d;
}
inline int __double2hiint(double d) {
  uint64_t u; std::memcpy(&u, &d, 8); return int(uint32_t(u >> 32));
}
inline int __double2loint(double d) {
  uint64_t u; std::memcpy(&u, &d, 8); return int(uint32_t(u));
}
inline double __hiloint2double(int hi, int lo) {
  const uint64_t u = (uint64_t(uint32_t(hi)) << 32) | uint32_t(lo);
  double d; std::memcpy(&d, &u, 8); return d;
}
inline float __int2float_rn(int v) { return float(v); }
inline double __int2double_rn(int v) { return double(v); }
inline int __float2int_rz(float f) { return int(f); }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline double2 make_double2(double x, double y) { return {x, y}; }
