// The synchronisation steps K4 and K6 are built from, alone, for timing:
// a grid-wide barrier of a cooperative launch (K4's grid route, one a
// column), a cluster barrier (K4's cluster route, one a column; K6, three
// an op), and a cluster barrier followed by a dependent read of a peer's
// shared memory (the DSMEM round trip that follows every K4 cluster
// barrier). Each kernel runs `iters` steps; the caller times launches of
// different `iters` with CUDA events and takes the difference.
// kernels/sync_probe.py drives it; chip_smoke.py and probes/k4_k6.py read
// the chain floors of K4 and K6 from it.
#include <cooperative_groups.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) grid_steps(int iters, int* sink) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) sink[0] = iters;
}

// kind 1: cluster barriers; kind 2: each step also reads the value the
// next CTA of the cluster wrote in the step before and writes it plus one.
__global__ void __launch_bounds__(kThreads)
    cluster_steps(int iters, int dsmem, int* sink) {
  __shared__ int box[2];
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int q = static_cast<int>(cl.block_rank());
  if (threadIdx.x == 0) box[0] = box[1] = q;
  int x = 0;
  cl.sync();
  for (int i = 0; i < iters; ++i) {
    if (dsmem && threadIdx.x == 0) {
      x = *cl.map_shared_rank(box + (i & 1), (q + 1) % C);
      box[(i + 1) & 1] = x + 1;
    }
    cl.sync();
  }
  if (q == 0 && threadIdx.x == 0) sink[0] = x;
  cl.sync();
}

}  // namespace

// kind 0: `ctas` CTAs (at most one an SM) in a cooperative launch, `iters`
// grid.sync() each; kind 1: one cluster of `ctas` CTAs (1..16), `iters`
// cluster barriers; kind 2: as 1, each barrier followed by a DSMEM read.
// sink: one int32 of device memory.
extern "C" int elx_sync_probe(int kind, int ctas, int iters, void* sink,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* s = static_cast<int*>(sink);
  if (ctas < 1 || iters < 0) return cudaErrorInvalidValue;
  if (kind == 0) {
    void* args[] = {&iters, &s};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(grid_steps), dim3(ctas), dim3(kThreads),
        args, 0, st);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  if ((kind != 1 && kind != 2) || ctas > 16) return cudaErrorInvalidValue;
  cudaError_t e = elx::cluster::prepare(cluster_steps, ctas, 0);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      elx::cluster::config(attr, 1, ctas, kThreads, 0, st);
  const int dsmem = kind == 2;
  e = cudaLaunchKernelEx(&cfg, cluster_steps, iters, dsmem, s);
  return e != cudaSuccess ? e : cudaGetLastError();
}
