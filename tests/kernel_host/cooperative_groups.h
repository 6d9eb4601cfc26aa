// cluster_group of the host stand-in: ranks and the mapping of a shared-memory
// address into another block of the cluster.
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_rank; }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    size_t off = (unsigned char*)p - emu_smem();
    if (off >= emu_cl->smem || rank >= (unsigned)emu_cl->C) __builtin_trap();
    return (T*)(emu_cl->bufs[rank].data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}
