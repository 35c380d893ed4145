// K7: the symmetric matrix-vector product from the lower triangle.
//
//   y = H v,   H = tril(A) + tril(A, -1)^T
//
// for an n x n A with row stride lda and unit column stride. Only entries
// with column <= row are read: the strict upper triangle may hold anything
// (even NaN) and does not reach y.
//
// Replaces the TPU kernel elementalx/kernels/symv.py:_symv_lower_tpu (body
// _symv_kernel; entry points symv_lower and symv_lower_trailing). That
// kernel walks the lower (bs, bs) blocks of A with a scalar-prefetched
// block list, emits each block's contribution to both out[i] (A_ij v_j)
// and out[j] (A_ij^T v_i) as per-step partial rows, and segment-sums the
// partials outside the kernel.
//
// Design: the symv unit K5 uses (symv_unit.cuh) over the whole triangle,
// in one cooperative launch. A unit is 32 rows x 1024 columns of the lower
// triangle; each thread owns 4 columns and adds both A[r, c] v[c] (row
// sums, reduced across the block by a butterfly reduce-scatter) and
// A[r, c] v[r] for c < r (column sums, in registers). Units are dealt
// round-robin over the blocks in strip order; each block adds into its own
// partial y (one length-n vector per block, zeroed by the block). After
// one grid-wide barrier each row's owner sums the partials in block order.
// No float atomics: the same inputs give the same bits on every run.
//
// What bounds it: the bytes of the lower triangle, n^2/2 words (537 MB at
// n = 16384 in float, 0.16 ms at 3.35 TB/s); torch.mv on a fully stored
// symmetric matrix reads twice that. The partial y's add 2 G n words of
// traffic (G blocks, 2 per SM), about 6% at n = 16384. What it gives up:
// vectorized loads (each row's four loads are 1 KB apart) and the
// diagonal units' wasted upper half.
#include <cooperative_groups.h>

#include "symv_unit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = elx::kSymvThreads;  // threads of a block
constexpr int kWarps = elx::kSymvWarps;
constexpr int kR = elx::kSymvR;              // rows of a unit
constexpr int kUW = elx::kSymvUW;            // columns of a unit
constexpr int kBlocksPerSM = 2;              // most blocks per SM

#define ELX_RETURN_IF_ERROR(expr)     \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

template <typename T>
struct SymvArgs {
  const T* a;     // (n, n), row stride lda; lower triangle read
  long long lda;
  int n;
  const T* v;     // (n,)
  T* y;           // (n,)
  T* ypart;       // (G, n) per-block partial y
};

template <typename T>
__global__ void __launch_bounds__(kThreads) symv_kernel(SymvArgs<T> g) {
  __shared__ T svr[kR];
  __shared__ T srow[kWarps][kR];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, G = gridDim.x, b = blockIdx.x;
  const int n = g.n;
  T* yp = g.ypart + static_cast<long long>(b) * n;
  const T* v = g.v;
  const auto vat = [v](int r) { return v[r]; };
  for (int r = tid; r < n; r += kThreads) yp[r] = T(0);

  // units in strip order, unit u to block u mod G: this block's first unit
  // in a strip is q0 = (b - units before the strip) mod G
  const int nstrips = (n + kR - 1) / kR;
  int q0 = b;
  for (int s = 0; s < nstrips; ++s) {
    const int rs = s * kR, re = min(rs + kR, n);
    const int nq = (re - 1) / kUW + 1;
    for (int q = q0; q < nq; q += G)
      elx::symv_unit(g.a, g.lda, n, vat, rs, re, q * kUW, yp, svr, srow);
    q0 -= nq % G;
    if (q0 < 0) q0 += G;
  }
  grid.sync();

  // y on the own rows: the G partials summed in block order
  for (int r = b * kThreads + tid; r < n; r += G * kThreads) {
    T s[4] = {T(0), T(0), T(0), T(0)};
    const T* col = g.ypart + r;
    int bb = 0;
    for (; bb + 4 <= G; bb += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s[k] += __ldcg(col + static_cast<long long>(bb + k) * n);
    }
    for (; bb < G; ++bb) s[0] += __ldcg(col + static_cast<long long>(bb) * n);
    g.y[r] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

template <typename T>
cudaError_t grid_size(int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  ELX_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, symv_kernel<T>, kThreads, 0));
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(SymvArgs<T> g, int grid, cudaStream_t st) {
  int want = 0;
  ELX_RETURN_IF_ERROR(grid_size<T>(&want));
  if (grid != want) return cudaErrorInvalidValue;
  void* args[] = {&g};
  ELX_RETURN_IF_ERROR(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(symv_kernel<T>), dim3(grid), dim3(kThreads),
      args, 0, st));
  return cudaGetLastError();
}

}  // namespace

// Blocks of the cooperative launch; the caller sizes ypart with it.
extern "C" int elx_symv_grid(int dtype, int* grid) {
  if (dtype == 0) return grid_size<float>(grid);
  if (dtype == 1) return grid_size<double>(grid);
  return cudaErrorInvalidValue;
}

// dtype: 0 float, 1 double. a: n x n with row stride lda (unit column
// stride), lower triangle read; v, y: (n,); ypart: (grid, n) scratch.
extern "C" int elx_symv_lower(int dtype, int n, const void* a, long long lda,
                              const void* v, void* y, void* ypart, int grid,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || lda < n || grid <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (dtype == 0)
    return launch<float>(
        SymvArgs<float>{static_cast<const float*>(a), lda, n,
                        static_cast<const float*>(v), static_cast<float*>(y),
                        static_cast<float*>(ypart)},
        grid, st);
  if (dtype == 1)
    return launch<double>(
        SymvArgs<double>{static_cast<const double*>(a), lda, n,
                         static_cast<const double*>(v),
                         static_cast<double*>(y), static_cast<double*>(ypart)},
        grid, st);
  return cudaErrorInvalidValue;
}
