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
// A Hopper SM has 227 KB of shared memory (the w = 512 block is 1 MB), and
// its blocks run in parallel, not in order. So the block and its inverse
// live in global memory (L2) as in K3a (potrf.cu), and the launch is
// cooperative: every block is resident, and one grid-wide barrier
// (grid.sync(), about 3.6 us) separates each phase from the next.
//
// Phases, all blocks taking part unless said otherwise:
//   init   work <- lower(S) padded to W = 32 * 2^p with an identity on the
//          padding diagonal; xinv <- 0; rows above r0 of out <- 0;
//   per 32-wide step k (three barriers):
//     potf2  block 0 factors the 32 x 32 diagonal block in shared memory
//            and inverts it;
//     trsm   A21 <- A21 inv(L_kk)^T, one warp per row;
//     syrk   A22 -= L21 L21^T on the lower tiles (gemm_tile.cuh);
//   invert the doubling inverse of K3a, two batched products a level;
//   final  out rows [r0, r0 + w) <- L11; invlh <- inv(L11)^T;
//   apply  out rows below <- pan rows below * invlh (gemm_tile.cuh).
// Every step does K3a's arithmetic in K3a's order, and the apply is K1's
// tile product, so in float the output equals [K3a's l11; K1(pan, K3a's
// invLH)] bit for bit when the compiler contracts the same expressions.
//
// What bounds it: at (16384, 512) the apply is 2 * 15872 * 512^2 = 8.3e9
// FLOPs (0.12 ms at 67 TFLOP/s); the factor is a chain of 16 dependent
// steps of three barriers each, and the doubling adds 8 more, about 0.2 ms
// of barriers alone. What it gives up: overlapping the factor's chain with
// the apply (the apply needs the whole inverse), tensor cores, and the
// idle blocks of the small factor phases.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "gemm_tile.cuh"

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
cudaError_t launch(TailArgs<T> g, int low_apply, int grid, cudaStream_t st) {
  int want = 0;
  ELX_RETURN_IF_ERROR(grid_both<T>(&want));
  if (grid != want) return cudaErrorInvalidValue;
  void* args[] = {&g};
  const void* fn = reinterpret_cast<const void*>(tail_kernel<T, false>);
  if constexpr (std::is_same<T, float>::value) {
    if (low_apply) fn = reinterpret_cast<const void*>(tail_kernel<T, true>);
  }
  ELX_RETURN_IF_ERROR(
      cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0, st));
  return cudaGetLastError();
}

}  // namespace

// Blocks of the cooperative launch.
extern "C" int elx_potrf_tail_grid(int dtype, int* grid) {
  if (dtype == 0) return grid_both<float>(grid);
  if (dtype == 1) return grid_both<double>(grid);
  return cudaErrorInvalidValue;
}

// dtype: 0 float, 1 double (low_apply only with float). sym: (w, w), row
// stride lds, unit column stride; pan: (rows, w) with strides sp0, sp1;
// out: (rows, w) contiguous; work, xinv: W * W; tmp: W * W / 4; invlh:
// w * w; flag: one int. Needs W = 32 * 2^p >= w and r0 + w <= rows.
extern "C" int elx_potrf_panel_tail(int dtype, int rows, int w, int W, int r0,
                                    int low_apply, const void* sym,
                                    long long lds, const void* pan,
                                    long long sp0, long long sp1, void* out,
                                    void* work, void* xinv, void* tmp,
                                    void* invlh, void* flag, int grid,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w <= 0 || W < w || W % kNB != 0 || r0 < 0 || r0 + w > rows ||
      grid <= 0 || (low_apply && dtype != 0))
    return cudaErrorInvalidValue;
#define ELX_TAIL_ARGS(T)                                                    \
  TailArgs<T> {                                                             \
    rows, w, W, r0, static_cast<const T*>(sym), lds,                        \
        static_cast<const T*>(pan), sp0, sp1, static_cast<T*>(out),         \
        static_cast<T*>(work), static_cast<T*>(xinv), static_cast<T*>(tmp), \
        static_cast<T*>(invlh), static_cast<int*>(flag)                     \
  }
  if (dtype == 0)
    return launch<float>(ELX_TAIL_ARGS(float), low_apply, grid, st);
  if (dtype == 1) return launch<double>(ELX_TAIL_ARGS(double), 0, grid, st);
#undef ELX_TAIL_ARGS
  return cudaErrorInvalidValue;
}
