// K10: the inverse of a batch of upper-triangular matrices, in one launch.
//
//   X_b = inv(U_b)     b = 0 .. batch-1, each U_b n x n upper triangular
//
// Replaces no TPU kernel. The JAX package inverts triangles in plain XLA
// (elementalx/blas/trinv.py: a batched 16 x 16 substitution, then log2(n/16)
// doubling levels of two batched products each), and the port ran the same
// chain as torch ops: about 280 host ops and 105 device kernels for one
// 512-wide inverse. QR's CholeskyQR2 panels make four inverses a panel, so
// the host issuing that chain left the card idle. K10 is the whole inverse,
// every matrix of the batch, in one launch.
//
// Reads U through any batch, row and column strides (a .mT view is read in
// place) and only its upper triangle: an entry below the diagonal is never
// read, and with `unit` neither is the diagonal (taken as 1). Writes X, zeros
// below the diagonal included, through its strides.
//
// Design. Column j of inv(U) solves U x = e_j and has nonzeros in rows 0..j
// only, so the columns are independent. A CTA takes W adjacent columns (a
// stripe) of one matrix and solves them by back substitution over 32-row
// tiles, the bottom tile first:
//   - the tile's 32 x 32 diagonal block of U is in shared memory, and a warp
//     a column solves the tile's rows, a lane a row scaled by its 1 / u_ii:
//     each x_k leaves lane k by a shuffle and every lane subtracts
//     (u_ik / u_ii) x_k, a chain of 32 shuffle-FMA steps with no branch;
//   - then every thread folds the solved 32 x W block into the right-hand
//     sides R (W x c1, in shared memory) of the rows above the tile
//     (right-looking), a thread a row: the row's 32 entries of U, W FMAs
//     each.
// A barrier waits for every load its threads issued before it, so each
// step's loads are issued after the step's first barrier: the first row of
// the update and the next tile's diagonal block are in flight while the
// tile is solved. The update's loads are a warp's neighbouring words when
// U's row stride is the smaller; where it is not (a row-major U), the
// wrapper passes J U^T J instead (J the order reversal): U read transposed
// and backwards, an upper triangle again, whose inverse J inv(U)^T J the
// kernel writes to X through the same reversal (negative strides).
// The stripe ending at column c1 costs about c1^2 W / 2 FMAs, so CTAs are
// dealt heaviest stripe first, the batch innermost, and the lighter ones fill
// the card behind them. W follows the shape (kernels/trinv.py:stripe_width):
// 4 where one matrix has to fill the card with its stripes, 16 where a batch
// does, so that U is read fewer times.
//
// Bound on the H100: n^3 / 3 operations a matrix at 67 TFLOP/s (FP32 FMA;
// FP64 on the tensor cores), 0.7 us at n = 512. The floor of this design is
// its dependency chain: n / 32 tile steps, each a 32-step shuffle chain, a
// round trip to memory for the rows' entries of U and two barriers, tens of
// microseconds at n = 512; and the heaviest stripe reads its whole triangle
// of U, c1^2 / 2 entries, on one SM. Above n = kMaxN the wrapper inverts the
// triangle's diagonal blocks of order kMaxN or less in one launch and joins
// them with K1 products (kernels/trinv.py).
//
// Arithmetic: float in float on the FP32 FMA units (never TF32), double in
// double on the FP64 ones. The sums of an entry of X run in a fixed order that
// does not depend on W, so both stripe widths give the same bits.
#include <cuda_runtime.h>

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t err_ = (expr);  \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32, kTile = 32;
constexpr int kMaxN = 1024;  // kernels/trinv.py:MAX_N

template <typename T>
struct TrinvArgs {
  int n, batch, stripes, unit;
  const T* U;
  long long sub, sur, suc;  // batch, row and column strides of U
  T* X;
  long long sxb, sxr, sxc;  // batch, row and column strides of X
};

// xt's row k (W entries) into registers, in 16-byte shared loads. The asm
// keeps the loads in the row loop: hoisted out of it, the 32 x W values of
// xt took every register and spilled.
template <int W>
__device__ __forceinline__ void xt_row(const float* p, float (&v)[W]) {
  static_assert(W % 4 == 0, "16-byte rows");
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
#pragma unroll
  for (int j = 0; j < W; j += 4)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[j]), "=f"(v[j + 1]), "=f"(v[j + 2]), "=f"(v[j + 3])
                 : "r"(a + 4 * j)
                 : "memory");
}

template <int W>
__device__ __forceinline__ void xt_row(const double* p, double (&v)[W]) {
  static_assert(W % 2 == 0, "16-byte rows");
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
#pragma unroll
  for (int j = 0; j < W; j += 2)
    asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
                 : "=d"(v[j]), "=d"(v[j + 1])
                 : "r"(a + 8 * j)
                 : "memory");
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads) trinv_kernel(const TrinvArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T ud[kTile][kTile + 1];         // the tile's diagonal block
  __shared__ __align__(16) T xt[kTile][W];   // the tile's rows of X

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x / a.batch;  // 0: the heaviest stripe
  const int b = blockIdx.x - rank * a.batch;
  const int c0 = (a.stripes - 1 - rank) * W;
  const int c1 = min(c0 + W, a.n);  // columns [c0, c1), rows [0, c1)
  const int nc = c1 - c0;
  const T* U = a.U + b * a.sub;
  T* X = a.X + b * a.sxb;
  T* R = reinterpret_cast<T*>(smem);  // R[j * c1 + i]: row i, column c0 + j

  // neighbouring threads on the smaller stride where they share a loop
  const long long aur = a.sur < 0 ? -a.sur : a.sur;
  const long long auc = a.suc < 0 ? -a.suc : a.suc;
  const long long axr = a.sxr < 0 ? -a.sxr : a.sxr;
  const long long axc = a.sxc < 0 ? -a.sxc : a.sxc;
  const bool kfast = auc <= aur, jfast = axc <= axr;
  constexpr int kCols = W > kWarps ? W / kWarps : 1;  // columns a warp
  constexpr int kPer = kTile * kTile / kThreads;      // of a diagonal block

  // this thread's entries of the diagonal block of the tile at r0 (h rows):
  // the upper ones, 1 on a unit diagonal, zeros below it and past h
  auto diag_load = [&](int r0, int h, T (&v)[kPer]) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int p = (tid + e * kThreads) / kTile;
      const int q = (tid + e * kThreads) % kTile;
      const int i = kfast ? p : q, k = kfast ? q : p;
      v[e] = T(0);
      if (i < h && k < h) {
        if (k > i)
          v[e] = U[(r0 + i) * a.sur + (r0 + k) * a.suc];
        else if (k == i)
          v[e] = a.unit ? T(1) : U[(r0 + i) * (a.sur + a.suc)];
      }
    }
  };
  // row i's entries of U in the columns of the tile at r0
  auto row_load = [&](int i, int r0, int h, T (&uk)[kTile]) {
    const T* Ui = U + i * a.sur + r0 * a.suc;
#pragma unroll
    for (int k = 0; k < kTile; ++k) uk[k] = k < h ? Ui[k * a.suc] : T(0);
  };

  // R[i][:] -= uk xt: row i's entries of U in the tile's columns times
  // the tile's rows of X
  auto fold = [&](int i, const T (&uk)[kTile]) {
    T acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = R[j * c1 + i];
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      T v[W];
      xt_row<W>(&xt[k][0], v);
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] -= uk[k] * v[j];
    }
#pragma unroll
    for (int j = 0; j < W; ++j) R[j * c1 + i] = acc[j];
  };

  int r0 = (c1 - 1) / kTile * kTile;
  T dv[kPer];
  diag_load(r0, c1 - r0, dv);
  for (int idx = tid; idx < W * c1; idx += kThreads) {
    const int j = idx / c1, i = idx - j * c1;
    R[idx] = i == c0 + j ? T(1) : T(0);
  }
  for (int idx = tid; idx < (a.n - c1) * nc; idx += kThreads) {
    const int rows = a.n - c1;
    const int i = c1 + (jfast ? idx / nc : idx % rows);
    const int j = jfast ? idx % nc : idx / rows;
    X[i * a.sxr + (c0 + j) * a.sxc] = T(0);
  }

  for (; r0 >= 0; r0 -= kTile) {
    const int h = min(kTile, c1 - r0);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int p = (tid + e * kThreads) / kTile;
      const int q = (tid + e * kThreads) % kTile;
      ud[kfast ? p : q][kfast ? q : p] = dv[e];
    }
    __syncthreads();  // ud staged, the tile's R final, xt free

    // The next tile's diagonal block and this update's first row are
    // loaded while the tile is solved. (A barrier waits for the loads its
    // threads issued before it, so they are issued after this one.)
    if (r0 >= kTile) diag_load(r0 - kTile, kTile, dv);
    T uk[kTile];
    if (tid < r0) row_load(tid, r0, h, uk);

    if (warp < W) {
      // lane i solves row i scaled by d_i = 1 / u_ii: r_i := d_i R_i, and
      // x_k = r_k leaves lane k for every lane, which subtracts
      // (d_i u_ik) x_k. No branch: u_ik is 0 below the diagonal and past
      // h, and a change to r_k after x_k left is not read.
      const T d = lane < h ? T(1) / ud[lane][lane] : T(0);
      T r[kCols], x[kCols];
      bool live[kCols];  // on or above the column: rows below stay 0
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = warp + q * kWarps;
        live[q] = lane < h && j < nc && r0 + lane <= c0 + j;
        r[q] = live[q] ? d * R[j * c1 + r0 + lane] : T(0);
        x[q] = T(0);
      }
#pragma unroll
      for (int k = kTile - 1; k >= 0; --k) {
        const T uh = d * ud[lane][k];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const T xk = __shfl_sync(0xffffffffu, r[q], k);
          x[q] = lane == k ? xk : x[q];
          r[q] -= uh * xk;
        }
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        xt[lane][warp + q * kWarps] = live[q] ? x[q] : T(0);
    }
    __syncthreads();  // xt holds the tile's rows of X

    for (int idx = tid; idx < h * nc; idx += kThreads) {
      const int i = jfast ? idx / nc : idx % h;
      const int j = jfast ? idx % nc : idx / h;
      X[(r0 + i) * a.sxr + (c0 + j) * a.sxc] = xt[i][j];
    }
    // R[i][:] -= U[i, r0:r0+h] xt for the rows above the tile; the
    // wrapper makes U's row stride the smaller one, so that a warp's loads
    // of one k are neighbouring words
    if (tid < r0) fold(tid, uk);
    for (int i = tid + kThreads; i < r0; i += kThreads) {
      T ui[kTile];
      row_load(i, r0, h, ui);
      fold(i, ui);
    }
  }
}

template <typename T, int W>
cudaError_t launch_w(TrinvArgs<T> a, cudaStream_t st) {
  a.stripes = (a.n + W - 1) / W;
  const long long grid = static_cast<long long>(a.batch) * a.stripes;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  // R; with the static arrays it may pass the 48 KB a launch gets unasked
  const size_t smem = static_cast<size_t>(W) * a.n * sizeof(T);
  ELX_RETURN_IF_ERROR(cudaFuncSetAttribute(
      trinv_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  trinv_kernel<T, W><<<static_cast<unsigned>(grid), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const TrinvArgs<T>& a, int width, cudaStream_t st) {
  if (width == 4) return launch_w<T, 4>(a, st);
  if (width == 16) return launch_w<T, 16>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// X_b = inv(U_b) for b < batch, U_b upper triangular n x n (unit != 0: its
// diagonal taken as 1 and not read). dtype: 0 float, 1 double; width: the
// stripe width W, 4 or 16; 1 <= n <= 1024. Strides in
// elements, any sign: U's batch, row and column, X's batch, row and column.
extern "C" int elx_trinv(int dtype, int width, int unit, int n, int batch,
                         const void* U, long long sub, long long sur,
                         long long suc, void* X, long long sxb, long long sxr,
                         long long sxc, void* stream) {
  if (n <= 0 || batch <= 0) return cudaSuccess;
  if (n > kMaxN) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(
        TrinvArgs<float>{n, batch, 0, unit, static_cast<const float*>(U), sub,
                         sur, suc, static_cast<float*>(X), sxb, sxr, sxc},
        width, st);
  if (dtype == 1)
    return launch<double>(
        TrinvArgs<double>{n, batch, 0, unit, static_cast<const double*>(U),
                          sub, sur, suc, static_cast<double*>(X), sxb, sxr,
                          sxc},
        width, st);
  return cudaErrorInvalidValue;
}
