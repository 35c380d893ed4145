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
// The panel is factored in groups of kNB = 32 columns. A group's pivot
// search is a reduction over all Mt rows that its next column needs: a
// chain of 32 dependent steps a group, 512 a 512-wide panel. What bounds
// the kernel is the cost of one such step, not FLOPs or bytes.
//
// Route "cluster" (this design, kernels/getrf.py:route picks it wherever
// the group's columns fit: float32 up to about 26000 rows, float64 up to
// about 13000). One thread-block cluster of C CTAs (C up to 16, the
// non-portable size) holds the group's 32 columns of all Mt rows in its
// shared memory, CTA q owning rows [q rpc, (q+1) rpc): at Mt = 16384 in
// float32, 16 CTAs of 1024 rows, 132 KB each (about 512 rows a CTA for
// shorter panels). A column costs one cluster
// barrier and two CTA barriers: each CTA publishes its best (|value|,
// row) in its own shared memory, double-buffered by column parity; after
// the cluster barrier one warp of every CTA reads the C candidates over
// DSMEM and reduces them (the order does not matter: "better" is a total
// order) and reads the winner's row from its owner's shared memory; after
// a CTA barrier each thread eliminates its rows and finds its candidate
// for the next column on the way; the warps' candidates meet in the
// second CTA barrier. The loop stores nothing to global memory (the
// cluster barrier's release would wait for it). The rows already elected
// are flags in shared memory. After the last column the same launch turns
// the group's pivot rows right of the group into U rows (the forward
// substitution with the group's unit lower 32 x 32 block, read from the
// owners' shared memory), so a group costs two launches: this one and the
// rank-32 update.
//
// Route "grid" (the first design), for panels whose group columns do not
// fit in 16 CTAs: a cooperative launch of at most one CTA per SM, each
// owning a contiguous share of the rows in shared memory (or in a global
// slab), one grid.sync() a column, every CTA reading all candidates back from L2;
// then a u12 launch; three launches a group.
//
// Both routes then update every row right of the group, A -= mbuf * ubuf,
// a rank-32 product: on K1's cp.async pipeline (gemm_f32_pipe.cuh) for
// float32 operands it can read in 16-byte pieces, on K1's FMA core
// (gemm_tile.cuh) otherwise; the two give the same bits. Rows elected
// earlier carry zero multipliers and come out unchanged. Every entry sees
// the same operations in the same order on either route, so the routes
// agree bit for bit.
//
// What each gives up: the update of the next group's columns is not
// overlapped with its factorization (a look-ahead), and the update runs
// over the full height, elected rows included (at most w of Mt rows).
#include <cooperative_groups.h>

#include <climits>

#include "cluster.cuh"
#include "gemm_f32_pipe.cuh"
#include "gemm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 32;          // columns of one group
constexpr int kLD = kNB + 1;     // row stride of the shared-memory slab
constexpr int kThreads = 256;    // threads of a grid-route CTA
constexpr int kMaxGrid = 1024;   // most CTAs a grid-route launch may use
constexpr int kUnused = INT_MAX; // used[r] of a row never elected
constexpr int kCT = 512;         // threads of a cluster-route CTA

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
__device__ __forceinline__ T magnitude(T x) {
  return x != x ? T(INFINITY) : (x < T(0) ? -x : x);
}

// (m, r) beats (bm, br): larger magnitude, then the lower row index.
template <typename T>
__device__ __forceinline__ bool better(T m, int r, T bm, int br) {
  return m > bm || (m == bm && r < br);
}

// The best (magnitude, row) of a warp, in every lane.
template <typename T>
__device__ __forceinline__ void warp_best(T& m, int& r) {
  for (int off = 16; off > 0; off /= 2) {
    const T om = __shfl_xor_sync(0xffffffffu, m, off);
    const int orr = __shfl_xor_sync(0xffffffffu, r, off);
    if (better(om, orr, m, r)) {
      m = om;
      r = orr;
    }
  }
}

// Block-wide best (magnitude, row) over kW warps; every thread gets the
// result. red_m / red_r hold one entry per warp.
template <int kW, typename T>
__device__ void block_best(T& m, int& r, T* red_m, int* red_r) {
  warp_best(m, r);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // red_* may still be read from the previous call
  if (lane == 0) {
    red_m[warp] = m;
    red_r[warp] = r;
  }
  __syncthreads();
  m = red_m[0];
  r = red_r[0];
  for (int k = 1; k < kW; ++k)
    if (better(red_m[k], red_r[k], m, r)) {
      m = red_m[k];
      r = red_r[k];
    }
}

__global__ void init_used_kernel(int* used, int Mt) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Mt;
       i += gridDim.x * blockDim.x)
    used[i] = kUnused;
}

cudaError_t init_used(int* used, int Mt, cudaStream_t st) {
  init_used_kernel<<<(Mt + 255) / 256 < 1024 ? (Mt + 255) / 256 : 1024, 256,
                     0, st>>>(used, Mt);
  return cudaGetLastError();
}

// a[:, j0+nb:] -= mbuf[:, :nb] * ubuf[:nb, :rest], ubuf's rows rest apart.
template <typename T>
cudaError_t update(T* a, int Mt, int w, int j0, int nb, T* mbuf, T* ubuf,
                   cudaStream_t st) {
  const int rest = w - j0 - nb;
  const elx::GemmArgs upd{Mt,   rest, nb, mbuf, kNB, 1, 0, ubuf, rest, 1,
                          0,    a + j0 + nb,  w,    1, 0, -1.0, 1.0, 0};
  if constexpr (sizeof(T) == 4) {
    // the pipeline reads 16-byte pieces: 16-byte aligned bases, rows a
    // multiple of 4 floats apart
    const bool aligned =
        reinterpret_cast<uintptr_t>(a + j0 + nb) % 16 == 0 && w % 4 == 0 &&
        rest % 4 == 0 && reinterpret_cast<uintptr_t>(mbuf) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(ubuf) % 16 == 0;
    if (aligned) return elx::pipe::launch<true, false, 4>(upd, st);
  }
  return elx::launch_gemm<T, T, T>(upd, 1, st);
}

// ===== route "cluster" =====================================================

struct ClusterArgs {
  void* a;     // (Mt, w) row-major panel, factored in place
  int Mt, w, j0, nb;
  int rpc;     // rows owned by one CTA
  int* used;   // (Mt,) column that elected the row, or kUnused
  int* piv;    // (w,) row elected for each column
  void* mbuf;  // (Mt, kNB) masked multipliers of the group
  void* ubuf;  // (kNB, w - j0 - nb) the group's U rows right of it
};

// Dynamic shared memory of a cluster CTA: the slab of rpc rows, then a
// byte a row (elected or not).
template <typename T>
size_t cluster_smem(int rpc) {
  return (static_cast<size_t>(rpc) * kLD * sizeof(T) + rpc + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(kCT) group_cluster(ClusterArgs g) {
  constexpr int kW = kCT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T wcand_m[kW];  // each warp's best (|value|, row)
  __shared__ int wcand_r[kW];
  __shared__ T cand_m[2];  // this CTA's best by column parity (DSMEM)
  __shared__ int cand_r[2];
  __shared__ T prow[kNB];  // the pivot row of the current column
  __shared__ int pr[kNB];  // the group's pivot rows
  __shared__ T L[kNB][kNB + 1];
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int q = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  T* a = static_cast<T*>(g.a);
  T* slab = reinterpret_cast<T*>(smem_raw);
  unsigned char* elected =
      smem_raw + static_cast<size_t>(g.rpc) * kLD * sizeof(T);
  const int r0 = q * g.rpc;
  const int nloc = max(0, min(g.rpc, g.Mt - r0));
  const int nb = g.nb, w = g.w, j0 = g.j0;

  // consecutive threads on consecutive columns of a row (coalesced)
  for (int e = tid; e < nloc * kNB; e += kCT) {
    const int lr = e / kNB, c = e % kNB;
    if (c < nb)
      slab[lr * kLD + c] = a[static_cast<long long>(r0 + lr) * w + j0 + c];
  }
  for (int lr = tid; lr < nloc; lr += kCT)
    elected[lr] = g.used[r0 + lr] != kUnused;
  __syncthreads();

  // This CTA's candidate for column jj from each thread's (m, r): the
  // warps' best, then warp 0's, into slot jj & 1. One barrier.
  auto publish = [&](T m, int r, int jj) {
    warp_best(m, r);
    if (lane == 0) {
      wcand_m[warp] = m;
      wcand_r[warp] = r;
    }
    __syncthreads();
    if (warp == 0) {
      m = lane < kW ? wcand_m[lane] : T(-1);
      r = lane < kW ? wcand_r[lane] : INT_MAX;
      warp_best(m, r);
      if (lane == 0) {
        cand_m[jj & 1] = m;
        cand_r[jj & 1] = r;
      }
    }
  };

  {
    T m = T(-1);
    int r = INT_MAX;
    for (int lr = tid; lr < nloc; lr += kCT) {
      if (elected[lr]) continue;
      const T v = magnitude(slab[lr * kLD]);
      if (better(v, r0 + lr, m, r)) {
        m = v;
        r = r0 + lr;
      }
    }
    publish(m, r, 0);
  }
  for (int jj = 0; jj < nb; ++jj) {
    const int par = jj & 1;
    cl.sync();  // every CTA's candidate for column jj is published
    // Warp 0 reduces the C candidates (the order does not matter:
    // "better" is a total order) and reads the winner's row from its
    // owner's shared memory: two DSMEM round trips, one warp a CTA. No
    // global store in the loop: the barrier's release would wait for it.
    if (warp == 0) {
      T m = T(-1);
      int r = INT_MAX;
      if (lane < C) {
        m = *cl.map_shared_rank(cand_m + par, lane);
        r = *cl.map_shared_rank(cand_r + par, lane);
      }
      warp_best(m, r);
      const int who = r / g.rpc;
      prow[lane] =
          lane >= jj && lane < nb
              ? *cl.map_shared_rank(slab + (r - who * g.rpc) * kLD + lane,
                                    who)
              : T(0);
      if (lane == 0) pr[jj] = r;
    }
    __syncthreads();
    const int p = pr[jj];
    const T pv = prow[jj];
    const T safe = pv == T(0) ? T(1) : pv;
    // eliminate this thread's rows, and find its candidate for column
    // jj + 1 among them on the way (the pivot row in registers and the
    // column loop unrolled, so that a row's loads go out together)
    T prow_r[kNB];
#pragma unroll
    for (int c = 0; c < kNB; ++c) prow_r[c] = prow[c];
    T bm = T(-1);
    int br = INT_MAX;
    for (int lr = tid; lr < nloc; lr += kCT) {
      if (r0 + lr == p) {
        elected[lr] = 1;
        continue;
      }
      if (elected[lr]) continue;
      T* s = slab + lr * kLD;
      const T l = s[jj] / safe;
      s[jj] = l;
#pragma unroll
      for (int c = 1; c < kNB; ++c)
        if (c > jj && c < nb) s[c] -= l * prow_r[c];
      if (jj + 1 < nb) {
        const T v = magnitude(s[jj + 1]);
        if (better(v, r0 + lr, bm, br)) {
          bm = v;
          br = r0 + lr;
        }
      }
    }
    if (jj + 1 < nb) publish(bm, br, jj + 1);
  }
  __syncthreads();

  T* mbuf = static_cast<T*>(g.mbuf);
  for (int e = tid; e < nloc * kNB; e += kCT) {
    const int lr = e / kNB, c = e % kNB;
    if (c < nb) {
      const T v = slab[lr * kLD + c];
      a[static_cast<long long>(r0 + lr) * w + j0 + c] = v;
      mbuf[static_cast<long long>(r0 + lr) * kNB + c] = elected[lr] ? T(0) : v;
    }
  }
  if (tid < nb) {
    if (q == 0) g.piv[j0 + tid] = pr[tid];
    if (pr[tid] / g.rpc == q) g.used[pr[tid]] = j0 + tid;
  }

  // The group's pivot rows right of the group become U rows:
  //   u_t = a[p_t, c] - sum_{t' < t} L[t, t'] u_t',  L[t, t'] = a[p_t, j0+t'],
  // one thread per column c across the cluster, written in place and into
  // ubuf (kNB, w - j0 - nb). A barrier a pass keeps the compiler from
  // holding all of L in registers across the passes.
  const int c0 = j0 + nb;
  if (c0 < w) {
    cl.sync();  // every slab holds its final multipliers
    for (int e = tid; e < kNB * kNB; e += kCT) {
      const int t = e / kNB, t2 = e % kNB;
      T x = T(0);
      if (t < nb && t2 < t) {
        const int p = pr[t], who = p / g.rpc;
        x = *cl.map_shared_rank(slab + (p - who * g.rpc) * kLD + t2, who);
      }
      L[t][t2] = x;
    }
    __syncthreads();
    T* ubuf = static_cast<T*>(g.ubuf);
    const int ldu = w - c0;
    for (int pass = 0; pass < ldu; pass += C * kCT) {
      const int c = c0 + pass + q * kCT + tid;
      if (c < w) {
        // the pivot rows' entries first, all loads in flight, then the
        // substitution and the stores
        T u[kNB];
#pragma unroll
        for (int t = 0; t < kNB; ++t)
          u[t] = t < nb ? a[static_cast<long long>(pr[t]) * w + c] : T(0);
#pragma unroll
        for (int t = 0; t < kNB; ++t) {
          T s = u[t];
#pragma unroll
          for (int t2 = 0; t2 < t; ++t2) s -= L[t][t2] * u[t2];
          u[t] = s;
        }
#pragma unroll
        for (int t = 0; t < kNB; ++t)
          if (t < nb) {
            a[static_cast<long long>(pr[t]) * w + c] = u[t];
            ubuf[static_cast<long long>(t) * ldu + (c - c0)] = u[t];
          }
      }
      __syncthreads();
    }
  }
  cl.sync();  // no CTA leaves while a peer may read its shared memory
}

template <typename T>
cudaError_t getrf_cluster(T* a, int Mt, int w, int csize, int* piv,
                          int* used, T* mbuf, T* ubuf, cudaStream_t st) {
  const int rpc = (Mt + csize - 1) / csize;
  const size_t smem = cluster_smem<T>(rpc);
  cudaFuncAttributes fa{};
  ELX_RETURN_IF_ERROR(cudaFuncGetAttributes(&fa, group_cluster<T>));
  int optin = 0;
  ELX_RETURN_IF_ERROR(elx::cluster::smem_optin(&optin));
  if (smem + fa.sharedSizeBytes > static_cast<size_t>(optin))
    return cudaErrorInvalidValue;
  ELX_RETURN_IF_ERROR(elx::cluster::prepare(group_cluster<T>, csize, smem));
  int most = 0;
  ELX_RETURN_IF_ERROR(
      elx::cluster::max_active(group_cluster<T>, csize, kCT, smem, &most));
  if (most < 1) return cudaErrorInvalidConfiguration;
  ELX_RETURN_IF_ERROR(init_used(used, Mt, st));
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      elx::cluster::config(attr, 1, csize, kCT, smem, st);
  for (int j0 = 0; j0 < w; j0 += kNB) {
    const int nb = w - j0 < kNB ? w - j0 : kNB;
    const ClusterArgs g{a, Mt, w, j0, nb, rpc, used, piv, mbuf, ubuf};
    ELX_RETURN_IF_ERROR(cudaLaunchKernelEx(&cfg, group_cluster<T>, g));
    if (w - j0 - nb > 0)
      ELX_RETURN_IF_ERROR(update(a, Mt, w, j0, nb, mbuf, ubuf, st));
  }
  return cudaGetLastError();
}

// ===== route "grid" (the first design) ====================================

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
    block_best<kThreads / 32>(m, r, red_m, red_r);
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
    block_best<kThreads / 32>(m, r, red_m, red_r);
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

template <typename T>
cudaError_t getrf_grid(T* a, int Mt, int w, int* piv, int* used, T* mbuf,
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

  ELX_RETURN_IF_ERROR(init_used(used, Mt, st));

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
    ELX_RETURN_IF_ERROR(update(a, Mt, w, j0, nb, mbuf, ubuf, st));
  }
  return cudaGetLastError();
}

}  // namespace

// route: 0 "grid", 1 "cluster" (csize CTAs, 1..16). Scratch the caller
// allocates, in elements of the panel's type unless noted: mbuf Mt * 32;
// ubuf 32 * w; used Mt int32; and for the grid route only (null for the
// cluster route): cand 2 * 1024 * 32; cand_mag 2 * 1024; cand_row
// 2 * 1024 int32; slab (Mt + 1024) * 33. dtype: 0 float, 1 double. a:
// (Mt, w) row-major contiguous, factored in place; piv: (w,) int32.
extern "C" int elx_getrf_panel(int route, int csize, int dtype, int Mt,
                               int w, void* a, void* piv, void* used,
                               void* mbuf, void* ubuf, void* cand,
                               void* cand_mag, void* cand_row, void* slab,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Mt <= 0 || w <= 0 || Mt < w) return cudaErrorInvalidValue;
  int* p = static_cast<int*>(piv);
  int* u = static_cast<int*>(used);
  if (route == 1) {
    if (csize < 1 || csize > 16) return cudaErrorInvalidValue;
    if (dtype == 0)
      return getrf_cluster<float>(static_cast<float*>(a), Mt, w, csize, p,
                                  u, static_cast<float*>(mbuf),
                                  static_cast<float*>(ubuf), st);
    if (dtype == 1)
      return getrf_cluster<double>(static_cast<double*>(a), Mt, w, csize, p,
                                   u, static_cast<double*>(mbuf),
                                   static_cast<double*>(ubuf), st);
    return cudaErrorInvalidValue;
  }
  if (route != 0) return cudaErrorInvalidValue;
  int* cr = static_cast<int*>(cand_row);
  if (dtype == 0)
    return getrf_grid<float>(
        static_cast<float*>(a), Mt, w, p, u, static_cast<float*>(mbuf),
        static_cast<float*>(ubuf), static_cast<float*>(cand),
        static_cast<float*>(cand_mag), cr, static_cast<float*>(slab), st);
  if (dtype == 1)
    return getrf_grid<double>(
        static_cast<double*>(a), Mt, w, p, u, static_cast<double*>(mbuf),
        static_cast<double*>(ubuf), static_cast<double*>(cand),
        static_cast<double*>(cand_mag), cr, static_cast<double*>(slab), st);
  return cudaErrorInvalidValue;
}
