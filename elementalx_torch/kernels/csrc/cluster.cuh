// Thread-block cluster helpers shared by K4 (getrf.cu), K6 (sb2tr.cu) and
// the synchronisation probe (sync_probe.cu): the launch of a grid of
// clusters, the number of clusters the card holds at once, and the
// release/acquire flags through which clusters hand work to each other.
//
// Inside a cluster the kernels use cooperative_groups::this_cluster():
// sync() is the hardware cluster barrier (arrive.release / wait.acquire,
// so shared-memory writes before it are seen by every CTA of the cluster
// after it), and map_shared_rank() gives a peer CTA's shared memory
// (distributed shared memory, DSMEM). A CTA must not exit while a peer may
// still read its shared memory: every kernel ends with a cluster barrier.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace elx {
namespace cluster {
namespace {

namespace cg = cooperative_groups;

#define ELX_CLUSTER_TRY(expr)         \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// ---- device side: flags between clusters ---------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Spin until *p >= target (acquire). Called by one thread. A wait of
// more than 2^34 cycles (about 10 s) can only be a fault of the schedule:
// it traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void wait_at_least(const int* p, int target) {
  const long long start = clock64();
  while (ld_acquire(p) < target) {
    if (clock64() - start > (1ll << 34)) __trap();
    __nanosleep(64);
  }
}

// ---- host side -------------------------------------------------------------

// Launch configuration of `clusters` clusters of `csize` CTAs of `threads`
// threads with `smem` bytes of dynamic shared memory each. attr must
// outlive the launch call.
inline cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int clusters,
                                 int csize, int threads, size_t smem,
                                 cudaStream_t st) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(clusters * csize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Set the kernel's dynamic shared memory and, above the portable cluster
// size of 8, allow the larger cluster.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int csize, size_t smem) {
  ELX_CLUSTER_TRY(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (csize > 8)
    ELX_CLUSTER_TRY(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  return cudaSuccess;
}

// Clusters of the given shape that the card holds at once (0 if none).
template <typename Kernel>
cudaError_t max_active(Kernel kernel, int csize, int threads, size_t smem,
                       int* out) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(attr, 1, csize, threads, smem, 0);
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<void*>(kernel), &cfg);
}

// The largest dynamic shared memory a CTA may ask for on this device.
inline cudaError_t smem_optin(int* out) {
  int dev = 0;
  ELX_CLUSTER_TRY(cudaGetDevice(&dev));
  return cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

}  // namespace
}  // namespace cluster
}  // namespace elx
