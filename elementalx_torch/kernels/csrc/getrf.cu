// K4: partial-pivoted LU of a tall panel, rows kept in place and marked.
//
//   (out, piv) for a row-major (Mt, w) panel A, Mt >= w
//
// Column j elects the row of largest |value| among the rows not yet
// elected (the lowest row index on equal magnitudes, as LAPACK's i?amax
// and jnp.argmax do; a NaN counts as the largest), records it in piv[j],
// and every other unelected row r becomes l_r = A[r, j] / pivot, with a
// zero pivot dividing by 1 (no NaN, no error). Rows never move: an elected
// row holds its U row from its pivot column on and its multipliers before
// it, a row never elected holds w multipliers. The wrapper's gather turns
// this into the LAPACK packed layout (kernels/getrf.py:packed_getrf).
//
// Replaces the TPU kernel elementalx/kernels/getrf.py:getrf_panel (body
// _getrf_kernel). That design holds the whole panel, transposed, in up to
// 16 MB of VMEM, and gathers pivot rows with one-hot MXU products. An SM
// has 227 KB of shared memory and a 16384 x 512 f32 panel is 32 MB, so
// neither carries over.
//
// Design. The panel stays in global memory (and L2). It is factored in
// groups of kNB = 32 columns, three launches a group, in stream order:
//   group  a cooperative kernel, at most one CTA per SM, each CTA owning a
//          contiguous share of the rows. The CTA copies its rows' 32 group
//          columns into shared memory (16384 x 32 x 4 B = 2 MB over the
//          whole grid, 34 KB a CTA) and factors them column by column.
//          Each column costs one grid-wide barrier (grid.sync()): before
//          it, every CTA publishes its local pivot candidate (|value|, row
//          and the row's group values); after it, every CTA reduces the
//          candidates itself, takes the winner's row from the published
//          copy and eliminates its own rows, then looks for its candidate
//          of the next column. Candidates are double-buffered by column
//          parity, so no second barrier is needed. The CTA writes its rows
//          back, and beside them the group's multipliers with the rows
//          already elected zeroed (mbuf).
//   u12    the group's pivot rows, right of the group, become U rows: a
//          unit-lower 32 x 32 forward substitution, one thread a column,
//          written in place and into a contiguous copy (ubuf).
//   gemm   every unelected row, right of the group: A -= mbuf * ubuf, a
//          rank-32 update through K1's tile code (gemm_tile.cuh). Rows
//          elected earlier have zero multipliers and are left as they are.
//
// Why a cooperative launch: the pivot search of a column is a reduction
// over all Mt rows that the next column needs, 512 grid-wide dependencies
// per 512-wide sub-panel. A launch per column would cost some 3 us each;
// grid.sync() costs about one round trip through L2. The grid is sized
// from the occupancy query (never from Mt), so every CTA is resident.
//
// What bounds it: the chain of barriers and of latency-bound column steps,
// not FLOPs or bytes; the rank-32 updates are K1 products of K = 32. What
// it gives up: the group and u12 launches per 32 columns; the full-height
// rank-32 update, which also runs over rows with zero multipliers; FP32
// FMA instead of tensor cores in the update.
#include <cooperative_groups.h>

#include <climits>

#include "gemm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 32;          // columns of one group
constexpr int kLD = kNB + 1;     // row stride of the shared-memory slab
constexpr int kThreads = 256;    // threads of a group CTA
constexpr int kMaxGrid = 1024;   // most CTAs a group launch may use
constexpr int kUnused = INT_MAX; // used[r] of a row never elected

struct GroupArgs {
  void* a;          // (Mt, w) row-major panel, factored in place
  int Mt, w, j0, nb;
  int rpc;          // rows owned by one CTA
  int* used;        // (Mt,) column that elected the row, or kUnused
  int* piv;         // (w,) row elected for each column
  void* mbuf;       // (Mt, kNB) masked multipliers of the group
  void* cand;       // (2, kMaxGrid, kNB) candidate rows
  void* cand_mag;   // (2, kMaxGrid) candidate magnitudes
  int* cand_row;    // (2, kMaxGrid) candidate row indices
  void* slab;       // global slab when shared memory is too small, or null
};

template <typename T>
__device__ __forceinline__ T magnitude(T x) {
  return x != x ? T(INFINITY) : (x < T(0) ? -x : x);
}

// (m, r) beats (bm, br): larger magnitude, then the lower row index.
template <typename T>
__device__ __forceinline__ bool better(T m, int r, T bm, int br) {
  return m > bm || (m == bm && r < br);
}

// Block-wide best (magnitude, row) over kThreads threads; every thread
// gets the result. red_m / red_r hold one entry per warp.
template <typename T>
__device__ void block_best(T& m, int& r, T* red_m, int* red_r) {
  for (int off = 16; off > 0; off /= 2) {
    const T om = __shfl_down_sync(0xffffffffu, m, off);
    const int orr = __shfl_down_sync(0xffffffffu, r, off);
    if (better(om, orr, m, r)) {
      m = om;
      r = orr;
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red_* may still be read from the previous call
  if (lane == 0) {
    red_m[warp] = m;
    red_r[warp] = r;
  }
  __syncthreads();
  m = red_m[0];
  r = red_r[0];
  for (int k = 1; k < kThreads / 32; ++k)
    if (better(red_m[k], red_r[k], m, r)) {
      m = red_m[k];
      r = red_r[k];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) group_kernel(GroupArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T prow[kNB];
  __shared__ T red_m[kThreads / 32];
  __shared__ int red_r[kThreads / 32];
  cg::grid_group grid = cg::this_grid();

  T* a = static_cast<T*>(g.a);
  T* slab = g.slab ? static_cast<T*>(g.slab) +
                         static_cast<long long>(blockIdx.x) * g.rpc * kLD
                   : reinterpret_cast<T*>(smem_raw);
  T* cand = static_cast<T*>(g.cand);
  T* cand_mag = static_cast<T*>(g.cand_mag);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * g.rpc;
  const int nloc = max(0, min(g.rpc, g.Mt - r0));
  const int nb = g.nb;

  for (int e = tid; e < nloc * nb; e += kThreads) {
    const int lr = e / nb, c = e % nb;
    slab[lr * kLD + c] = a[static_cast<long long>(r0 + lr) * g.w + g.j0 + c];
  }
  __syncthreads();

  // Publish this CTA's candidate for group column jj into buffer jj & 1.
  auto publish = [&](int jj) {
    T m = T(-1);
    int r = INT_MAX;
    for (int lr = tid; lr < nloc; lr += kThreads) {
      if (g.used[r0 + lr] != kUnused) continue;
      const T v = magnitude(slab[lr * kLD + jj]);
      if (better(v, r0 + lr, m, r)) {
        m = v;
        r = r0 + lr;
      }
    }
    block_best(m, r, red_m, red_r);
    const int par = jj & 1;
    const long long slot = static_cast<long long>(par) * kMaxGrid + blockIdx.x;
    if (tid == 0) {
      cand_mag[slot] = m;
      g.cand_row[slot] = r;
    }
    if (r != INT_MAX && tid >= jj && tid < nb)
      cand[slot * kNB + tid] = slab[(r - r0) * kLD + tid];
  };

  publish(0);
  grid.sync();
  for (int jj = 0; jj < nb; ++jj) {
    const int j = g.j0 + jj;
    const int par = jj & 1;
    // Every CTA reduces all candidates of this column itself.
    T m = T(-1);
    int r = INT_MAX;
    for (int b = tid; b < gridDim.x; b += kThreads) {
      const long long slot = static_cast<long long>(par) * kMaxGrid + b;
      const T bm = cand_mag[slot];
      const int br = g.cand_row[slot];
      if (better(bm, br, m, r)) {
        m = bm;
        r = br;
      }
    }
    block_best(m, r, red_m, red_r);
    const int p = r;
    const int who = p / g.rpc;  // the CTA that owns row p published it
    if (tid >= jj && tid < nb)
      prow[tid] = cand[(static_cast<long long>(par) * kMaxGrid + who) * kNB +
                       tid];
    if (blockIdx.x == 0 && tid == 0) g.piv[j] = p;
    __syncthreads();
    const T pv = prow[jj];
    const T safe = pv == T(0) ? T(1) : pv;
    for (int lr = tid; lr < nloc; lr += kThreads) {
      const int row = r0 + lr;
      if (row == p) {
        g.used[row] = j;
        continue;
      }
      if (g.used[row] != kUnused) continue;
      T* s = slab + lr * kLD;
      const T l = s[jj] / safe;
      s[jj] = l;
      for (int c = jj + 1; c < nb; ++c) s[c] -= l * prow[c];
    }
    __syncthreads();
    if (jj + 1 < nb) {
      publish(jj + 1);
      grid.sync();
    }
  }

  T* mbuf = static_cast<T*>(g.mbuf);
  for (int e = tid; e < nloc * nb; e += kThreads) {
    const int lr = e / nb, c = e % nb;
    const T v = slab[lr * kLD + c];
    a[static_cast<long long>(r0 + lr) * g.w + g.j0 + c] = v;
    mbuf[static_cast<long long>(r0 + lr) * kNB + c] =
        g.used[r0 + lr] == kUnused ? v : T(0);
  }
}

// The group's pivot rows right of the group become U rows:
//   u_t = a[p_t, c] - sum_{t' < t} L[t, t'] u_t',  L[t, t'] = a[p_t, j0+t'],
// one thread per column c, written in place and into ubuf (kNB, ldu).
template <typename T>
__global__ void u12_kernel(T* a, int w, int j0, int nb, const int* piv,
                           T* ubuf, int ldu) {
  __shared__ T L[kNB][kNB + 1];
  __shared__ int pr[kNB];
  if (threadIdx.x < nb) pr[threadIdx.x] = piv[j0 + threadIdx.x];
  __syncthreads();
  for (int e = threadIdx.x; e < kNB * kNB; e += blockDim.x) {
    const int t = e / kNB, t2 = e % kNB;
    L[t][t2] = (t < nb && t2 < t)
                   ? a[static_cast<long long>(pr[t]) * w + j0 + t2]
                   : T(0);
  }
  __syncthreads();
  const int c0 = j0 + nb;
  const int c = c0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= w) return;
  T u[kNB];
#pragma unroll
  for (int t = 0; t < kNB; ++t) {
    if (t < nb) {
      T s = a[static_cast<long long>(pr[t]) * w + c];
#pragma unroll
      for (int t2 = 0; t2 < t; ++t2) s -= L[t][t2] * u[t2];
      u[t] = s;
      a[static_cast<long long>(pr[t]) * w + c] = s;
      ubuf[static_cast<long long>(t) * ldu + (c - c0)] = s;
    } else {
      u[t] = T(0);
    }
  }
}

__global__ void init_used_kernel(int* used, int Mt) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Mt;
       i += gridDim.x * blockDim.x)
    used[i] = kUnused;
}

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
cudaError_t getrf_panel(T* a, int Mt, int w, int* piv, int* used, T* mbuf,
                        T* ubuf, T* cand, T* cand_mag, int* cand_row,
                        T* slab_scratch, cudaStream_t st) {
  int dev = 0, sms = 0, max_smem = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  ELX_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  int coop = 0;
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;

  // At most one CTA per SM, and no more CTAs than rows for kThreads each.
  int grid = (Mt + kThreads - 1) / kThreads;
  grid = grid < sms ? grid : sms;
  grid = grid < kMaxGrid ? grid : kMaxGrid;
  const int rpc = (Mt + grid - 1) / grid;
  size_t smem = static_cast<size_t>(rpc) * kLD * sizeof(T);
  // leave room for the kernel's static shared memory
  const bool in_smem = smem + 4096 <= static_cast<size_t>(max_smem);
  if (!in_smem) smem = 0;
  ELX_RETURN_IF_ERROR(cudaFuncSetAttribute(
      group_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  int per_sm = 0;
  ELX_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, group_kernel<T>, kThreads, smem));
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;

  init_used_kernel<<<(Mt + 255) / 256 < 1024 ? (Mt + 255) / 256 : 1024, 256,
                     0, st>>>(used, Mt);
  ELX_RETURN_IF_ERROR(cudaGetLastError());

  for (int j0 = 0; j0 < w; j0 += kNB) {
    const int nb = w - j0 < kNB ? w - j0 : kNB;
    GroupArgs g{a,    Mt,   w,        j0,   nb,       rpc,
                used, piv,  mbuf,     cand, cand_mag, cand_row,
                in_smem ? nullptr : slab_scratch};
    void* args[] = {&g};
    ELX_RETURN_IF_ERROR(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(group_kernel<T>), dim3(grid), dim3(kThreads),
        args, smem, st));
    const int rest = w - j0 - nb;
    if (rest <= 0) continue;
    u12_kernel<T><<<(rest + 127) / 128, 128, 0, st>>>(a, w, j0, nb, piv,
                                                      ubuf, rest);
    ELX_RETURN_IF_ERROR(cudaGetLastError());
    // a[:, j0+nb:] -= mbuf[:, :nb] * ubuf[:nb, :rest]
    const elx::GemmArgs upd{Mt,   rest, nb, mbuf, kNB, 1, 0, ubuf, rest, 1,
                            0,    a + j0 + nb,  w,    1, 0, -1.0, 1.0, 0};
    ELX_RETURN_IF_ERROR((elx::launch_gemm<T, T, T>(upd, 1, st)));
  }
  return cudaGetLastError();
}

}  // namespace

// Scratch the caller allocates, in elements of the panel's type unless
// noted: mbuf Mt * 32; ubuf 32 * w; cand 2 * 1024 * 32; cand_mag 2 * 1024;
// slab (Mt + 1024) * 33; and as int32: used Mt, cand_row 2 * 1024.
// dtype: 0 float, 1 double. a: (Mt, w) row-major contiguous, factored in
// place; piv: (w,) int32.
extern "C" int elx_getrf_panel(int dtype, int Mt, int w, void* a, void* piv,
                               void* used, void* mbuf, void* ubuf, void* cand,
                               void* cand_mag, void* cand_row, void* slab,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Mt <= 0 || w <= 0 || Mt < w) return cudaErrorInvalidValue;
  int* p = static_cast<int*>(piv);
  int* u = static_cast<int*>(used);
  int* cr = static_cast<int*>(cand_row);
  if (dtype == 0)
    return getrf_panel<float>(
        static_cast<float*>(a), Mt, w, p, u, static_cast<float*>(mbuf),
        static_cast<float*>(ubuf), static_cast<float*>(cand),
        static_cast<float*>(cand_mag), cr, static_cast<float*>(slab), st);
  if (dtype == 1)
    return getrf_panel<double>(
        static_cast<double*>(a), Mt, w, p, u, static_cast<double*>(mbuf),
        static_cast<double*>(ubuf), static_cast<double*>(cand),
        static_cast<double*>(cand_mag), cr, static_cast<double*>(slab), st);
  return cudaErrorInvalidValue;
}
