// K5: one latrd panel of the Householder tridiagonalization.
//
//   (P, W, tau) for columns [k0, k0 + w) of a real symmetric (M, M)
//   row-major matrix A whose lower triangle is read (rows and columns
//   >= k0), w <= nb <= 128, any M.
//
// Column jl (global column gj = k0 + jl, pivot row gp = gj + 1), as in
// elementalx/lapack/condense.py:_tridiag_panel:
//   acur = A[:, gj] - V[:, :jl] W[gj, :jl]^T - W[:, :jl] V[gj, :jl]^T
//   (v, tau, beta) = householder(acur, gp)
//   y = A_lower-symmetric[k0:, k0:] v
//   p = tau (y - V (W^T v) - W (V^T v));  w = p - (tau/2 v^T p) v
// P's column holds acur on rows <= gj, beta on row gp and v below; W's
// column holds w. The panel arrays are kept transposed, (nb, M), so a
// column is contiguous; rows < k0 and columns >= w stay as the caller
// zeroed them.
//
// Replaces the TPU kernel elementalx/kernels/latrd.py:latrd_panel (body
// _latrd_kernel). That design holds V and W transposed in VMEM, (S, nb,
// TS) each, 8 MB at M=8192, and streams (TS, TS) lower tiles through a
// two-slot buffer. An SM has 227 KB of shared memory, so V, W and every
// length-M vector live in global memory (and L2) here.
//
// Design: one cooperative launch per panel, all blocks resident; each
// column costs four grid-wide barriers, one per data dependency:
//   1. acur for the thread's own rows, and the block's partial sigma^2;
//   2. every block reduces the sigma^2 partials in the same fixed order,
//      forms the reflector (v is computed on the fly from acur), writes
//      its rows of V and P, adds its share of the symv's tiles into its
//      own partial y (ypart, one length-M vector per block) and its rows'
//      share of W^T v and V^T v;
//   3. the G partial y's are summed in block order, 64 rows a block, the
//      blocks that touched no row of a strip skipped (SymvTiles::
//      sum_partials, eight loads in flight a thread); the panel dots are
//      reduced;
//   4. p for the own rows and the block's partial v^T p; after the
//      barrier every block sums those and writes w for its rows.
// The symv runs on SymvTiles (symv_unit.cuh, shared with K7): 64 x 64
// tiles of the trailing lower triangle stream through a TMA ring in shared
// memory, each used for both A_IJ v_J and A_IJ^T v_I; the block's tiles
// are a contiguous range of the triangle from the strip that holds the
// pivot row (strips above it meet v = 0). A does not change within a
// panel, so the first tiles of column j + 1's symv are loaded while the
// block works through the rest of column j and its barriers. No float
// atomics anywhere: every sum has a fixed order, so the result does not
// change from run to run. Row gp of W (needed by the next column's acur
// in every block) is recomputed by each block with the same function the
// row's owner uses, which saves a fifth barrier.
//
// What bounds it: the symv's lower-triangle traffic. Column j+1's symv
// needs column j's reflector, so each column streams the trailing
// triangle again: w (m0^2/2) words a panel of order m0 = M - k0 (16.9 GB,
// 5.05 ms at (8192, 0, 128)), about M^3/6 words over a whole reduction.
// Then 4 barriers per column. What it gives up: tensor cores for the
// panel products; overlapping the barriers with the symv.
#include <cooperative_groups.h>

#include "symv_unit.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = elx::kSymvThreads;  // threads of a block
constexpr int kWarps = elx::kSymvWarps;
constexpr int kMaxNB = 128;                  // widest panel
constexpr int kBlocksPerSM = 2;              // most blocks per SM

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
struct LatrdArgs {
  const T* a;   // (M, M), row stride lda, lower triangle read
  long long lda;
  int M, k0, w, nb;
  T* Pt;        // (nb, M) output P, transposed
  T* Wt;        // (nb, M) output W, transposed
  T* Vt;        // (nb, M) the reflectors, transposed
  T* tau;       // (nb,)
  T* acur;      // (M,) corrected current column
  T* ypart;     // (G, M) per-block partial y, zero on entry
  T* yg;        // (M,) y
  T* pbuf;      // (M,) p
  T* pnorm;     // (G,) partial sigma^2
  T* pdots;     // (G, 2 nb) partial W^T v | V^T v
  T* dots;      // (2 nb,) W^T v | V^T v
  T* pvp;       // (G,) partial v^T p
};

// Sum over the block; every thread gets the same value (fixed order).
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read from the previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T s = T(0);
#pragma unroll
  for (int k = 0; k < kWarps; ++k) s += red[k];
  return s;
}

// Sum of G per-block partials, in the same order in every block.
template <typename T>
__device__ T partials_sum(const T* p, int G, T* red) {
  T v = T(0);
  for (int b = threadIdx.x; b < G; b += kThreads) v += __ldcg(p + b);
  return block_sum(v, red);
}

template <typename T>
struct Reflector {
  int gp;
  T denom, tau, beta;
  const T* acur;
  // v[r]: zero above gp, 1 at gp, acur / denom below
  __device__ __forceinline__ T v(int r) const {
    return r > gp ? __ldcg(acur + r) / denom : (r == gp ? T(1) : T(0));
  }
};

// sum_c V[r, c] x[c] + W[r, c] y[c] over the panel's first jl columns,
// four columns at a time so that the loads of a row overlap (a fixed
// order, so the same inputs give the same bits).
template <typename T>
__device__ __forceinline__ T panel_dot(const LatrdArgs<T>& g, int r, int jl,
                                       const T* x, const T* y) {
  T s[4] = {T(0), T(0), T(0), T(0)};
  const T* vt = g.Vt + r;
  const T* wt = g.Wt + r;
  int c = 0;
  for (; c + 4 <= jl; c += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long off = static_cast<long long>(c + k) * g.M;
      s[k] += __ldcg(vt + off) * x[c + k] + __ldcg(wt + off) * y[c + k];
    }
  }
  for (; c < jl; ++c) {
    const long long off = static_cast<long long>(c) * g.M;
    s[0] += __ldcg(vt + off) * x[c] + __ldcg(wt + off) * y[c];
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// p[r] = tau (y[r] - sum_c V[r, c] (W^T v)[c] + W[r, c] (V^T v)[c]).
// Not inlined: the row's owner and every block's recomputation of row
// gp must give the same bits.
template <typename T>
__device__ __noinline__ T p_row(const LatrdArgs<T>& g, int r, int jl, T tau,
                                const T* sdots) {
  return tau * (__ldcg(g.yg + r) -
                panel_dot(g, r, jl, sdots, sdots + kMaxNB));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    latrd_kernel(const __grid_constant__ CUtensorMap map, LatrdArgs<T> g) {
  extern __shared__ uint8_t smem[];
  __shared__ T red[kWarps];
  __shared__ T sVg[kMaxNB], sWg[kMaxNB];
  __shared__ T sdots[2 * kMaxNB];
  __shared__ T s_wnext, s_pgp;
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = gridDim.x, b = blockIdx.x;
  const int M = g.M, k0 = g.k0, nb = g.nb;
  const int gtid = b * kThreads + tid, nthr = G * kThreads;
  T* yp = g.ypart + static_cast<long long>(b) * M;
  if (tid == 0) s_wnext = T(0);
  // the symv's tiles over the trailing block; column jl's walk starts at
  // the strip holding its pivot row (local row jl + 1)
  elx::SymvTiles<T> tiles(smem, &map, k0, k0, M - k0);
  long long lo, hi;
  tiles.range(tiles.strip_of(0 + 1), b, G, lo, hi);
  tiles.prefetch(lo, hi);

  for (int jl = 0; jl < g.w; ++jl) {
    const int gj = k0 + jl, gp = gj + 1;
    __syncthreads();  // s_wnext from the previous column
    for (int c = tid; c < jl; c += kThreads) {
      const long long off = static_cast<long long>(c) * M + gj;
      sVg[c] = __ldcg(g.Vt + off);
      sWg[c] = c == jl - 1 ? s_wnext : __ldcg(g.Wt + off);
    }
    __syncthreads();

    // ---- 1. acur on the own rows; partial sigma^2
    T part = T(0);
    for (int r = k0 + gtid; r < M; r += nthr) {
      T x = r >= gj ? g.a[static_cast<long long>(r) * g.lda + gj]
                    : g.a[static_cast<long long>(gj) * g.lda + r];
      x -= panel_dot(g, r, jl, sWg, sVg);
      g.acur[r] = x;
      if (r > gp) part += x * x;
    }
    part = block_sum(part, red);
    if (tid == 0) g.pnorm[b] = part;
    grid.sync();

    // ---- 2. reflector; V and P rows; symv tiles; panel dots
    Reflector<T> h;
    {
      const T sigma2 = partials_sum(g.pnorm, G, red);
      const T alpha = __ldcg(g.acur + gp);
      const T norm = sqrt(alpha * alpha + sigma2);
      const T beta0 = alpha < T(0) ? norm : -norm;
      const bool trivial = sigma2 == T(0);
      h.gp = gp;
      h.acur = g.acur;
      h.denom = trivial ? T(1) : alpha - beta0;
      h.tau = trivial ? T(0)
                      : (beta0 - alpha) / (beta0 == T(0) ? T(1) : beta0);
      h.beta = trivial ? alpha : beta0;
    }
    if (gtid == 0) g.tau[jl] = h.tau;
    for (int r = k0 + gtid; r < M; r += nthr) {
      const long long off = static_cast<long long>(jl) * M + r;
      const T v = h.v(r);
      g.Vt[off] = v;
      g.Pt[off] = r > gp ? v : (r == gp ? h.beta : __ldcg(g.acur + r));
    }
    tiles.walk([&h](int r) { return h.v(r); }, k0, lo, hi, yp);
    if (jl + 1 < g.w) {
      tiles.range(tiles.strip_of(jl + 2), b, G, lo, hi);
      tiles.prefetch(lo, hi);
    }
    {
      const int nrows = M - gp;
      const int ch = (nrows + G - 1) / G;
      const int r0 = gp + b * ch, r1 = min(r0 + ch, M);
      for (int c = warp; c < jl; c += kWarps) {
        T sw = T(0), sv = T(0);
        for (int r = r0 + lane; r < r1; r += 32) {
          const T v = h.v(r);
          const long long off = static_cast<long long>(c) * M + r;
          sw += __ldcg(g.Wt + off) * v;
          sv += __ldcg(g.Vt + off) * v;
        }
        for (int o = 16; o > 0; o /= 2) {
          sw += __shfl_down_sync(0xffffffffu, sw, o);
          sv += __shfl_down_sync(0xffffffffu, sv, o);
        }
        if (lane == 0) {
          g.pdots[static_cast<long long>(b) * 2 * nb + c] = sw;
          g.pdots[static_cast<long long>(b) * 2 * nb + nb + c] = sv;
        }
      }
    }
    grid.sync();

    // ---- 3. y on the trailing rows; the panel dots
    tiles.sum_partials(g.ypart, M, k0, tiles.strip_of(jl + 1), g.yg);
    if (warp == 0) {
      for (int e = b; e < 2 * jl; e += G) {
        const int slot = e < jl ? e : nb + e - jl;
        T s = T(0);
        for (int bb = lane; bb < G; bb += 32)
          s += __ldcg(g.pdots + static_cast<long long>(bb) * 2 * nb + slot);
        for (int o = 16; o > 0; o /= 2) s += __shfl_down_sync(0xffffffffu, s, o);
        if (lane == 0) g.dots[slot] = s;
      }
    }
    grid.sync();

    // ---- 4. p on the own rows; partial v^T p. Each block zeroes its
    // own partial y for the next column (only it writes there).
    for (int r = k0 + tid; r < M; r += kThreads) yp[r] = T(0);
    for (int c = tid; c < jl; c += kThreads) {
      sdots[c] = __ldcg(g.dots + c);
      sdots[kMaxNB + c] = __ldcg(g.dots + nb + c);
    }
    __syncthreads();
    part = T(0);
    for (int r = k0 + gtid; r < M; r += nthr) {
      const T p = p_row(g, r, jl, h.tau, sdots);
      g.pbuf[r] = p;
      part += h.v(r) * p;
    }
    part = block_sum(part, red);
    if (tid == 0) {
      g.pvp[b] = part;
      s_pgp = gp < M ? p_row(g, gp, jl, h.tau, sdots) : T(0);
    }
    grid.sync();

    // ---- w = p - (tau/2 v^T p) v on the own rows
    const T coef = h.tau * T(0.5) * partials_sum(g.pvp, G, red);
    for (int r = k0 + gtid; r < M; r += nthr)
      g.Wt[static_cast<long long>(jl) * M + r] =
          __ldcg(g.pbuf + r) - coef * h.v(r);
    if (tid == 0) s_wnext = s_pgp - coef;
  }
}

template <typename T>
cudaError_t grid_size(int* out) {
  constexpr int smem = elx::SymvTiles<T>::kSmemBytes;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  ELX_RETURN_IF_ERROR(cudaFuncSetAttribute(
      latrd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  ELX_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, latrd_kernel<T>, kThreads, smem));
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(LatrdArgs<T> g, int grid, cudaStream_t st) {
  constexpr int elem = sizeof(T);
  if (reinterpret_cast<uintptr_t>(g.a) % 16 || (g.lda * elem) % 16 ||
      g.lda < g.M)
    return cudaErrorInvalidValue;
  int want = 0;
  ELX_RETURN_IF_ERROR(grid_size<T>(&want));
  if (grid != want) return cudaErrorInvalidValue;
  CUtensorMap map;
  ELX_RETURN_IF_ERROR(elx::tma::make_map(
      &map,
      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      elem, g.a, g.M, g.M, g.lda, elx::kSymvT, elx::kSymvT,
      CU_TENSOR_MAP_SWIZZLE_NONE));
  void* args[] = {&map, &g};
  ELX_RETURN_IF_ERROR(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(latrd_kernel<T>), dim3(grid), dim3(kThreads),
      args, elx::SymvTiles<T>::kSmemBytes, st));
  return cudaGetLastError();
}

}  // namespace

// Blocks of the cooperative launch; the caller sizes the scratch with it.
extern "C" int elx_latrd_grid(int dtype, int* grid) {
  if (dtype == 0) return grid_size<float>(grid);
  if (dtype == 1) return grid_size<double>(grid);
  return cudaErrorInvalidValue;
}

// dtype: 0 float, 1 double. a: (M, M), row stride lda (a multiple of 16
// bytes, a 16-byte aligned base: the TMA reads it). Pt, Wt, Vt: (nb, M),
// zeroed by the caller; tau: (nb,) zeroed; scratch: acur, yg, pbuf (M);
// ypart (grid, M) zeroed; pnorm, pvp (grid); pdots (grid, 2 nb); dots
// (2 nb). Needs 0 <= k0, w <= nb <= 128, k0 + w <= M - 2.
extern "C" int elx_latrd_panel(int dtype, int M, int k0, int w, int nb,
                               const void* a, long long lda, void* Pt,
                               void* Wt, void* Vt, void* tau, void* acur,
                               void* ypart, void* yg, void* pbuf, void* pnorm, void* pdots,
                               void* dots, void* pvp, int grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || k0 < 0 || w < 0 || nb <= 0 || nb > kMaxNB || w > nb ||
      k0 + w > M - 2 || grid <= 0)
    return cudaErrorInvalidValue;
  if (w == 0) return cudaSuccess;
#define ELX_LATRD_ARGS(T)                                                  \
  LatrdArgs<T> {                                                           \
    static_cast<const T*>(a), lda, M, k0, w, nb, static_cast<T*>(Pt),      \
        static_cast<T*>(Wt), static_cast<T*>(Vt), static_cast<T*>(tau),    \
        static_cast<T*>(acur), static_cast<T*>(ypart), static_cast<T*>(yg), \
        static_cast<T*>(pbuf), static_cast<T*>(pnorm),                     \
        static_cast<T*>(pdots), static_cast<T*>(dots), static_cast<T*>(pvp) \
  }
  if (dtype == 0) return launch<float>(ELX_LATRD_ARGS(float), grid, st);
  if (dtype == 1) return launch<double>(ELX_LATRD_ARGS(double), grid, st);
#undef ELX_LATRD_ARGS
  return cudaErrorInvalidValue;
}
