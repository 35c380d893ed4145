// K3b and K3c: the fused Cholesky panel tail, in one launch.
//
//   out[r0 : r0 + w]      = L11 = chol(S)               (zeros above its
//                                                        diagonal)
//   out[r0 + w : rows]    = pan[r0 + w : rows] inv(L11)^T
//   out[0 : r0]           = 0
//
// for the symmetric (w, w) block S (lower triangle read) and a (rows, w)
// panel read through its strides. K3b is r0 = 0; K3c (the full-height
// column of the JAX package) passes the diagonal block's row offset r0 =
// kidx * w. Rows [r0, r0 + w) of the panel are never read: the symmetrized
// block is what the factor consumes. With low_apply, both operands of the
// L21 product are rounded to bfloat16 (nearest even) and the products are
// summed in float, as the JAX kernel's DEFAULT-precision dot does. A block
// that is not numerically positive definite (a pivot that is not > 0, or
// a NaN) poisons every row from r0 on with NaN; rows above r0 stay zero.
//
// Replaces the TPU kernels elementalx/kernels/potrf.py:potrf_panel_tail
// (body _potrf_kernel) and potrf_panel_tail_full (body _potrf_kernel_full),
// which share _factor_block and _apply_dot. The TPU kernel factors the
// whole block in VMEM in a transposed layout on grid step 0 and streams
// one (w, w) tile of the panel per later step through one MXU product.
// Hopper runs blocks in parallel, not in order, so the apply cannot simply
// follow the factor in grid order; what can follow it is each column
// block of L21, which needs only the matching row-block of inv(L11).
//
// Three routes, picked by kernels/potrf.py:route from w and the dtype:
//
// Route "cluster" (w <= 512 float32, w <= 384 float64; this design): one
// launch of clusters of nt = ceil(w / 32) CTAs (potrf.cu's chol_kernel,
// one instantiation shared with K3a, so L11 is K3a's bit for bit). The
// first cluster to start (an atomic ticket) runs K3a's factor on chip and
// stores row-block j of X = inv(L11) (as invlh = X^T) after step j,
// publishing j + 1 steps with a release store; it never waits for another
// cluster. Every CTA of the other clusters, and the factor's CTAs once
// the factor is done, takes strips of 64 rows (32 in float64) of pan21
// from an atomic counter, holds a strip transposed in shared memory
// (cp.async), and forms column block j of L21 = sum_{m <= j} pan21[:, m]
// X[j, m]^T as soon as step j is published (an acquire spin that traps
// after about 10 s), a thread a 4 x 2 block (2 x 2 in float64), one FMA
// chain over ascending k a value. The grid holds no more clusters than
// the card runs at once. So the product, 8.3 GFLOP at (16384, 512) as a
// dense one and half of it on X's triangle, follows the factor's chain
// instead of waiting for it: the route is bounded by the larger of the
// chain (K3a's) and the product on the card's FP32 FMAs (about 0.06 ms
// at 67 TFLOP/s; the 64 x 32 blocks run at about half of it, bound by
// shared-memory reads, and the strips a CTA takes during the chain wait
// for its steps).
//
// Route "blocked" (wider blocks: GenDefEig's (8192, 2048)): K3a's blocked
// route for (L11, invlh) (potrf.cu), then L21 = pan21 invlh as one product
// on K1's cp.async pipeline (float32 operands with a unit stride each) or
// its FMA core (float64, low_apply, other strides).
//
// Route "grid" (the first design, kept to be timed against): one
// cooperative launch, K3a's first design's steps between grid barriers
// (about 56 grid.sync()s at w = 512, each about 1.1 us over 132 CTAs),
// then the apply on K1's FMA-core tiles once the whole inverse is done.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "gemm_f32_pipe.cuh"
#include "gemm_tile.cuh"
#include "potrf_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 32;  // width of one factorization step
constexpr int kThreads = elx::kGemmThreads;
constexpr int kBlocksPerSM = 2;

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
__device__ __forceinline__ T qnan();
template <>
__device__ __forceinline__ float qnan<float>() {
  return __int_as_float(0x7fffffff);
}
template <>
__device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
struct TailArgs {
  int rows, w, W, r0;
  const T* sym;      // (w, w), row stride lds
  long long lds;
  const T* pan;      // (rows, w), strides sp0, sp1
  long long sp0, sp1;
  T* out;            // (rows, w) contiguous
  T* work;           // (W, W)
  T* xinv;           // (W, W)
  T* tmp;            // (W * W / 4)
  T* invlh;          // (w, w)
  int* flag;
};

// Shared memory of the phases; one phase at a time uses it.
template <typename T>
union TailSmem {
  elx::TileSmem<T> tile;
  struct {
    T s[kNB][kNB + 1];
    T x[kNB][kNB + 1];
  } f;
  T D[kNB][kNB + 1];
};

// Block 0: factor the 32 x 32 diagonal block at (k, k) of work, write
// L_kk (zeros above its diagonal) back and inv(L_kk) into xinv. K3a's
// potf2_kernel with 256 threads, each owning four entries.
template <typename T>
__device__ void potf2(const TailArgs<T>& g, int k, TailSmem<T>& sm) {
  const int tid = threadIdx.x;
  T* blk = g.work + static_cast<long long>(k) * g.W + k;
  T(*s)[kNB + 1] = sm.f.s;
  T(*x)[kNB + 1] = sm.f.x;
  for (int e = tid; e < kNB * kNB; e += kThreads) {
    const int ty = e / kNB, tx = e % kNB;
    s[ty][tx] = tx <= ty ? __ldcg(blk + static_cast<long long>(ty) * g.W + tx)
                         : T(0);
  }
  __syncthreads();
  for (int j = 0; j < kNB; ++j) {
    const T d = s[j][j];
    __syncthreads();  // every thread holds the pivot before it is replaced
    if (tid == 0 && !(d > T(0))) *g.flag = 1;
    const T r = sqrt(d);
    for (int e = tid; e < kNB * kNB; e += kThreads) {
      const int ty = e / kNB, tx = e % kNB;
      if (tx == j && ty >= j) s[ty][j] = ty == j ? r : s[ty][j] / r;
    }
    __syncthreads();
    for (int e = tid; e < kNB * kNB; e += kThreads) {
      const int ty = e / kNB, tx = e % kNB;
      if (tx > j && ty >= tx) s[ty][tx] -= s[ty][j] * s[tx][j];
    }
    __syncthreads();
  }
  // inv(L_kk) by forward substitution, lane c of warp 0 owning column c.
  if (tid < kNB) {
    const int c = tid;
    for (int i = 0; i < kNB; ++i) {
      T v = T(0);
      if (i >= c) {
        T sum = i == c ? T(1) : T(0);
        for (int q = c; q < i; ++q) sum -= s[i][q] * x[q][c];
        v = sum / s[i][i];
      }
      x[i][c] = v;
    }
  }
  __syncthreads();
  for (int e = tid; e < kNB * kNB; e += kThreads) {
    const int ty = e / kNB, tx = e % kNB;
    blk[static_cast<long long>(ty) * g.W + tx] = tx <= ty ? s[ty][tx] : T(0);
    g.xinv[static_cast<long long>(k + ty) * g.W + k + tx] = x[ty][tx];
  }
}

// Rows below the diagonal block: A21 <- A21 inv(L_kk)^T, in place, one
// warp per row over the whole grid (K3a's trsm_rows_kernel).
template <typename T>
__device__ void trsm_rows(const TailArgs<T>& g, int k, TailSmem<T>& sm) {
  T(*D)[kNB + 1] = sm.D;
  for (int e = threadIdx.x; e < kNB * kNB; e += kThreads)
    D[e / kNB][e % kNB] =
        __ldcg(g.xinv + static_cast<long long>(k + e / kNB) * g.W + k +
               e % kNB);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int nwarps = kThreads / 32;
  for (int r = k + kNB + blockIdx.x * nwarps + warp; r < g.W;
       r += gridDim.x * nwarps) {
    T* row = g.work + static_cast<long long>(r) * g.W + k;
    const T a = __ldcg(row + lane);
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kNB; ++j)
      acc += __shfl_sync(0xffffffffu, a, j) * D[lane][j];
    row[lane] = acc;
  }
}

// C[z] = alpha A[z] B[z] + beta C[z] over all tiles of a batch, dealt
// round-robin over the grid's blocks (lower_only tiles wholly above the
// diagonal are skipped).
template <typename TIn, typename T, bool kRoundBF16>
__device__ void grid_gemm(const elx::GemmArgs& g, int batch,
                          TailSmem<T>& sm) {
  constexpr int BM = elx::Tile<T>::BM, BN = elx::Tile<T>::BN;
  const int ntm = (g.M + BM - 1) / BM, ntn = (g.N + BN - 1) / BN;
  const long long per = static_cast<long long>(ntm) * ntn;
  for (long long t = blockIdx.x; t < per * batch; t += gridDim.x) {
    const long long z = t / per;
    const int ti = static_cast<int>((t % per) / ntn);
    const int tj = static_cast<int>(t % ntn);
    const int m0 = ti * BM, n0 = tj * BN;
    if (g.lower_only && n0 > m0 + BM - 1) continue;
    T acc[elx::Tile<T>::TM][elx::Tile<T>::TN];
    elx::tile_product<TIn, T, kRoundBF16, true>(
        g, static_cast<const TIn*>(g.A) + z * g.sab,
        static_cast<const TIn*>(g.B) + z * g.sbb, m0, n0, sm.tile, acc);
    elx::tile_store<T, T, true>(g, static_cast<T*>(g.C) + z * g.scb, m0, n0,
                                acc);
  }
}

template <typename T, bool kLowApply>
__global__ void __launch_bounds__(kThreads) tail_kernel(TailArgs<T> g) {
  __shared__ TailSmem<T> sm;
  cg::grid_group grid = cg::this_grid();
  const int W = g.W, w = g.w;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
  const long long nthr = static_cast<long long>(gridDim.x) * kThreads;

  // ---- init (K3a's init_kernel), and the zero rows above r0
  if (gtid == 0) *g.flag = 0;
  for (long long e = gtid; e < static_cast<long long>(W) * W; e += nthr) {
    const int i = static_cast<int>(e / W), j = static_cast<int>(e % W);
    T v = T(0);
    if (i < w && j < w) {
      if (j <= i) v = g.sym[i * g.lds + j];
    } else if (i == j) {
      v = T(1);
    }
    g.work[e] = v;
    g.xinv[e] = T(0);
  }
  for (long long e = gtid; e < static_cast<long long>(g.r0) * w; e += nthr)
    g.out[e] = T(0);
  grid.sync();

  // ---- the factor, 32 columns a step
  for (int k = 0; k < W; k += kNB) {
    if (blockIdx.x == 0) potf2(g, k, sm);
    grid.sync();
    const int rows = W - k - kNB;
    if (rows <= 0) continue;
    trsm_rows(g, k, sm);
    grid.sync();
    T* l21 = g.work + static_cast<long long>(k + kNB) * W + k;
    const elx::GemmArgs syrk{rows, rows, kNB, l21, W, 1, 0, l21, 1, W, 0,
                             l21 + kNB, W, 1, 0, -1.0, 1.0, 1};
    grid_gemm<T, T, false>(syrk, 1, sm);
    grid.sync();
  }

  // ---- the doubling inverse: for each pair (A at a0 = 2ts, C at c0 =
  // a0 + s), tmp_t = L[c0, a0] X[a0, a0];  X[c0, a0] = -X[c0, c0] tmp_t.
  for (long long s = kNB; s < W; s *= 2) {
    const int npair = static_cast<int>(W / (2 * s));
    const long long diag = 2 * s * (W + 1);
    const elx::GemmArgs left{static_cast<int>(s), static_cast<int>(s),
                             static_cast<int>(s), g.work + s * W, W, 1, diag,
                             g.xinv, W, 1, diag, g.tmp, s, 1, s * s,
                             1.0, 0.0, 0};
    grid_gemm<T, T, false>(left, npair, sm);
    grid.sync();
    const elx::GemmArgs right{static_cast<int>(s), static_cast<int>(s),
                              static_cast<int>(s), g.xinv + s * W + s, W, 1,
                              diag, g.tmp, s, 1, s * s, g.xinv + s * W, W, 1,
                              diag, -1.0, 0.0, 0};
    grid_gemm<T, T, false>(right, npair, sm);
    grid.sync();
  }

  // ---- L11 into its rows of out; invlh = inv(L11)^T
  const bool bad = __ldcg(g.flag) != 0;
  T* out11 = g.out + static_cast<long long>(g.r0) * w;
  for (long long e = gtid; e < static_cast<long long>(w) * w; e += nthr) {
    const int i = static_cast<int>(e / w), j = static_cast<int>(e % w);
    out11[e] =
        bad ? qnan<T>() : __ldcg(g.work + static_cast<long long>(i) * W + j);
    g.invlh[e] = __ldcg(g.xinv + static_cast<long long>(j) * W + i);
  }
  const int below = g.rows - g.r0 - w;
  if (below <= 0) return;
  grid.sync();

  // ---- the apply: L21 = pan21 invlh
  T* out21 = out11 + static_cast<long long>(w) * w;
  if (bad) {
    for (long long e = gtid; e < static_cast<long long>(below) * w; e += nthr)
      out21[e] = qnan<T>();
    return;
  }
  const elx::GemmArgs apply{below, w, w,
                            g.pan + static_cast<long long>(g.r0 + w) * g.sp0,
                            g.sp0, g.sp1, 0, g.invlh, w, 1, 0, out21, w, 1, 0,
                            1.0, 0.0, 0};
  grid_gemm<T, T, kLowApply>(apply, 1, sm);
}

template <typename T, bool kLowApply>
cudaError_t grid_size(int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  ELX_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tail_kernel<T, kLowApply>, kThreads, 0));
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  return cudaSuccess;
}

// The grid of every variant of the type (the smallest, if they differ);
// low_apply exists for float only.
template <typename T>
cudaError_t grid_both(int* out) {
  int a = 0, b = 0;
  ELX_RETURN_IF_ERROR((grid_size<T, false>(&a)));
  if constexpr (std::is_same<T, float>::value) {
    ELX_RETURN_IF_ERROR((grid_size<T, true>(&b)));
    if (b < a) a = b;
  }
  *out = a;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_grid(TailArgs<T> g, int low_apply, cudaStream_t st) {
  int grid = 0;
  ELX_RETURN_IF_ERROR(grid_both<T>(&grid));
  void* args[] = {&g};
  const void* fn = reinterpret_cast<const void*>(tail_kernel<T, false>);
  if constexpr (std::is_same<T, float>::value) {
    if (low_apply) fn = reinterpret_cast<const void*>(tail_kernel<T, true>);
  }
  ELX_RETURN_IF_ERROR(
      cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, st));
  return cudaGetLastError();
}

template <typename T>
cudaError_t panel_tail(int route, int rows, int w, int r0, int low_apply,
                       const T* sym, long long lds, const T* pan,
                       long long sp0, long long sp1, T* out, T* ws,
                       int* flags, cudaStream_t st) {
  if (route == 0) {
    int W = kNB;
    while (W < w) W *= 2;
    const long long WW = static_cast<long long>(W) * W;
    const TailArgs<T> g{rows, w,  W,        r0,           sym,
                        lds,  pan, sp0,     sp1,          out,
                        ws,   ws + WW, ws + 2 * WW, ws + 2 * WW + WW / 4,
                        flags};
    return launch_grid<T>(g, low_apply, st);
  }
  if (route == 1) {
    T* invlh = ws + elx::chol::kExchange;  // (w, w)
    const elx::chol::Call<T> c{w,   rows, r0,  low_apply, 0,     sym,
                               lds, pan,  sp0, sp1,       out,   w,
                               invlh, w,  flags, ws};
    return elx::chol::cluster_call(c, st);
  }
  if (route != 2) return cudaErrorInvalidValue;
  // the blocked route's own scratch, then inv(L11)^T
  T* invlh = ws + elx::chol::kExchange +
             2LL * w * elx::chol::kClusterMaxW<T>;
  ELX_RETURN_IF_ERROR(elx::chol::blocked_call(
      w, sym, lds, out + static_cast<long long>(r0) * w, w, invlh, w, ws,
      flags, st));
  if (r0 > 0)
    ELX_RETURN_IF_ERROR(cudaMemsetAsync(
        out, 0, static_cast<size_t>(r0) * w * sizeof(T), st));
  const int below = rows - r0 - w;
  if (below <= 0) return cudaSuccess;
  const long long first = static_cast<long long>(r0) + w;
  const elx::GemmArgs apply{below, w, w, pan + first * sp0, sp0, sp1, 0,
                            invlh, w, 1, 0, out + first * w, w, 1, 0,
                            1.0, 0.0, 0};
  if constexpr (std::is_same<T, float>::value) {
    if (low_apply) return elx::launch_gemm<T, T, T, true>(apply, 1, st);
    if (elx::pipe::unit_strides(apply))
      return elx::pipe::launch_any<3>(apply, st);
  }
  return elx::launch_gemm<T, T, T>(apply, 1, st);
}

}  // namespace

// route: 0 "grid", 1 "cluster", 2 "blocked"; dtype: 0 float, 1 double
// (low_apply only with float). sym: (w, w), row stride lds, unit column
// stride; pan: (rows, w) with strides sp0, sp1; out: (rows, w) contiguous.
// ws and flags as kernels/potrf.py:workspace sizes them for the route
// (zeroed flags before the first call of the cluster and blocked routes;
// they are left zero). Needs r0 + w <= rows.
extern "C" int elx_potrf_panel_tail(int route, int dtype, int rows, int w,
                                    int r0, int low_apply, const void* sym,
                                    long long lds, const void* pan,
                                    long long sp0, long long sp1, void* out,
                                    void* ws, void* flags, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(flags);
  if (w <= 0 || r0 < 0 || r0 + w > rows || (low_apply && dtype != 0))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return panel_tail<float>(route, rows, w, r0, low_apply,
                             static_cast<const float*>(sym), lds,
                             static_cast<const float*>(pan), sp0, sp1,
                             static_cast<float*>(out),
                             static_cast<float*>(ws), f, st);
  if (dtype == 1)
    return panel_tail<double>(route, rows, w, r0, 0,
                              static_cast<const double*>(sym), lds,
                              static_cast<const double*>(pan), sp0, sp1,
                              static_cast<double*>(out),
                              static_cast<double*>(ws), f, st);
  return cudaErrorInvalidValue;
}
