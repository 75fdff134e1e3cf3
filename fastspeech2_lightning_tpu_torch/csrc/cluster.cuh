// Thread-block clusters for the chain kernels (mas_width1.cu, ctc_banded_lse.cu):
// a block's rank in its cluster, the cluster barrier, a hand-over of a few
// floats into a neighbour block's shared memory signalled on an mbarrier
// there, and the cluster launch with its occupancy check.
//
// A hand-over from block r to block r + 1 (distributed shared memory): the
// producer's threads store into the consumer's slot with st.shared::cluster
// and each arrives on the consumer's `full` barrier (release at cluster
// scope); the consumer waits on it (acquire at cluster scope), reads the
// slot from its own shared memory and arrives on the producer's `empty`
// barrier, which the producer waits on before it writes that slot again.
// Nothing else orders the two blocks, so a block on the left may run ahead
// of the block on its right by as many hand-overs as there are slots.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "tensor_core.cuh"

namespace fs2 {
namespace cluster {

__device__ __forceinline__ int rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// every thread of the cluster: arrive (release) and wait (acquire) for all
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// the address of `p` (in this block's shared memory) in block `r`'s
__device__ __forceinline__ uint32_t map(const void* p, int r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(tc::smem_u32(p)), "r"(r));
  return out;
}

__device__ __forceinline__ void store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

// one arrival on the mbarrier at `addr` (mapped), releasing this thread's
// earlier writes at cluster scope
__device__ __forceinline__ void arrive(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(addr) : "memory");
}

// wait until the phase of parity `parity` of this block's mbarrier `bar`
// has completed, acquiring what its arrivals released at cluster scope
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
      :: "r"(tc::smem_u32(bar)), "r"(parity) : "memory");
}

// The cluster scheduling policy a launch asks for: none unless the source is
// built with -DFS2T_CLUSTER_POLICY=1 (Spread) or 2 (LoadBalancing), as
// tools/cluster_chain_variants.py builds it to time them.
#ifndef FS2T_CLUSTER_POLICY
#define FS2T_CLUSTER_POLICY 0
#endif

// A launch configuration of `grid` blocks (a multiple of `size`) in clusters
// of `size` blocks (not to be copied: cfg points at attr)
struct Config {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  Config(int grid, int size, int threads, size_t smem, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (FS2T_CLUSTER_POLICY != 0) {
      attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
      attr[1].val.clusterSchedulingPolicyPreference =
          static_cast<cudaClusterSchedulingPolicy>(FS2T_CLUSTER_POLICY);
      cfg.numAttrs = 2;
    }
  }
  Config(const Config&) = delete;
};

// Clusters of `size` blocks of `threads` threads and `smem` bytes of dynamic
// shared memory the card holds at once, asked of the runtime once per device
// and (size, threads / 32) and kept: a kernel's shared memory is a function
// of those two.
struct Occupancy {
  std::atomic<int> known[kMaxDevices][9][33];  // 0: not asked yet; else 1 + clusters
};

template <typename Kernel>
inline cudaError_t max_active(Occupancy& once, Kernel kernel, int size, int threads, size_t smem,
                              int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices || size < 1 || size > 8 || threads % 32 || threads > 1024)
    return cudaErrorInvalidValue;
  std::atomic<int>& slot = once.known[dev][size][threads / 32];
  int k = slot.load(std::memory_order_acquire);
  if (k == 0) {
    Config c(size, size, threads, smem, nullptr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &c.cfg);
    if (err != cudaSuccess) return err;
    k = 1 + n;
    slot.store(k, std::memory_order_release);
  }
  *out = k - 1;
  return cudaSuccess;
}

// `kernel` over `grid` blocks (a multiple of `size`) in clusters of `size`;
// refuses with cudaErrorInvalidConfiguration a configuration of which the
// card holds no cluster at all, and returns what the launch reported.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Occupancy& once, Kernel kernel, int grid, int size, int threads,
                          size_t smem, cudaStream_t stream, Args... args) {
  int active = 0;
  cudaError_t err = max_active(once, kernel, size, threads, smem, &active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  Config c(grid, size, threads, smem, stream);
  err = cudaLaunchKernelEx(&c.cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace cluster
}  // namespace fs2
