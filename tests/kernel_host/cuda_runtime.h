// Host stand-in for the CUDA device environment, for rehearsing the port's
// kernels on the CPU (tests/test_torch_rehearsal.py): every thread of every
// block of a cluster is a std::thread, __syncthreads() a barrier of the
// block's threads, the cluster barrier one of all the cluster's threads, and
// dynamic shared memory a buffer per block.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __align__(n) __attribute__((aligned(n)))
struct uint3_ { unsigned x, y, z; };
extern thread_local uint3_ threadIdx, blockIdx, blockDim;
struct EmuCluster {
  int C, T; size_t smem;
  std::vector<std::vector<unsigned char>> bufs;    // per block
  std::vector<std::barrier<>*> block_bar;
  std::barrier<>* cluster_bar;
};
extern thread_local EmuCluster* emu_cl;
extern thread_local int emu_rank;
inline unsigned char* emu_smem() { return emu_cl->bufs[emu_rank].data(); }
inline void __syncthreads() { emu_cl->block_bar[emu_rank]->arrive_and_wait(); }
inline void __syncwarp() {}
// the split barrier: arrive does nothing, wait is the whole barrier
inline void emu_cluster_arrive() {}
inline void emu_cluster_wait() { emu_cl->cluster_bar->arrive_and_wait(); }
using std::min; using std::max;
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
template <class T> inline T __ldcg(const T* p) { return *(const volatile T*)p; }
template <class T> inline void __stcg(T* p, T v) { *(volatile T*)p = v; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
