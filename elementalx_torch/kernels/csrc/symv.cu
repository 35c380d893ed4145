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
// Two cores, both one cooperative launch over the lower triangle in which
// every block adds its share into its own partial y (one length-n vector
// per block, zeroed by the block), and after one grid-wide barrier each
// row's owner sums the partials in block order. No float atomics: the
// same inputs give the same bits on every run.
//
//   - "tma" (elx_symv_lower_tma), the H100 design: SymvTiles of
//     symv_unit.cuh, 64 x 64 tiles through a TMA ring, each used twice
//     from shared memory; the block's tiles are a contiguous range of the
//     triangle in strip order. The tensor map lies over the parent
//     storage from the 16-byte aligned address at or before A's first
//     element (c0 columns before it), so A = a[k0:, k0:] is read in place
//     at any k0; it needs a row stride that is a multiple of 16 bytes.
//   - "unit" (elx_symv_lower), the first design, for any row stride: the
//     scalar symv unit (32 rows x 1024 columns, each thread 4 columns 1
//     KB apart, row sums by a butterfly reduce-scatter), units dealt
//     round-robin over the blocks in strip order.
//
// What bounds it: the bytes of the lower triangle, n^2/2 words (537 MB at
// n = 16384 in float, 0.16 ms at 3.35 TB/s); torch.mv on a fully stored
// symmetric matrix reads twice that. The partial y's add about 3 G n
// words of traffic for the "unit" core (zeroing, the column updates, the
// final sum; G blocks, 2 per SM), mostly in L2; the "tma" core zeroes and
// sums only the rows each block touched, about two thirds of that. The
// "tma" core also reads the upper half of the diagonal tiles (1/128 of the
// triangle at n = 16384) and discards it.
#include <cooperative_groups.h>

#include "symv_unit.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = elx::kSymvThreads;  // threads of a block
constexpr int kWarps = elx::kSymvWarps;
constexpr int kR = elx::kSymvR;              // rows of a unit
constexpr int kUW = elx::kSymvUW;            // columns of a unit
#ifndef ELX_SYMV_BLOCKS_PER_SM
#define ELX_SYMV_BLOCKS_PER_SM 2
#endif
constexpr int kBlocksPerSM = ELX_SYMV_BLOCKS_PER_SM;  // most blocks per SM

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

// y on the block's own rows (after the grid barrier): the G partials
// summed in block order.
template <typename T>
__device__ void sum_partials(const T* ypart, int n, T* y) {
  const int G = gridDim.x;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < n;
       r += G * kThreads) {
    T s[4] = {T(0), T(0), T(0), T(0)};
    const T* col = ypart + r;
    int bb = 0;
    for (; bb + 4 <= G; bb += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s[k] += __ldcg(col + static_cast<long long>(bb + k) * n);
    }
    for (; bb < G; ++bb) s[0] += __ldcg(col + static_cast<long long>(bb) * n);
    y[r] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

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

  sum_partials(g.ypart, n, g.y);
}

template <typename T>
struct SymvTmaArgs {
  int n;
  const T* v;     // (n,)
  T* y;           // (n,)
  T* ypart;       // (G, n) per-block partial y
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    symv_tma_kernel(const __grid_constant__ CUtensorMap map, const int c0,
                    SymvTmaArgs<T> g) {
  extern __shared__ uint8_t smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, G = gridDim.x, b = blockIdx.x;
  const int n = g.n;
  elx::SymvTiles<T> tiles(smem, &map, 0, c0, n);
  long long lo, hi;
  tiles.range(b, G, lo, hi);
  tiles.prefetch(lo, hi);
  // the block zeroes the rows its tiles touch (all of them when it has no
  // tile, so that the sum below may read its partial)
  T* yp = g.ypart + static_cast<long long>(b) * n;
  const int ext = lo < hi ? tiles.extent(lo, hi) : n;
  for (int r = tid; r < ext; r += kThreads) yp[r] = T(0);
  __syncthreads();  // the barriers' initialisation; yp zero
  const T* v = g.v;
  tiles.walk([v](int r) { return v[r]; }, lo, hi, yp);
  grid.sync();
  tiles.sum_partials(g.ypart, n, g.y);
}

// Blocks of a cooperative launch of `kernel` with `smem` bytes of dynamic
// shared memory: at most kBlocksPerSM a SM, all resident.
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, int smem, int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  ELX_RETURN_IF_ERROR(cudaGetDevice(&dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  ELX_RETURN_IF_ERROR(
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  if (smem > 0)
    ELX_RETURN_IF_ERROR(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  ELX_RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem));
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = sms * (per_sm < kBlocksPerSM ? per_sm : kBlocksPerSM);
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, void** args, int grid,
                   cudaStream_t st) {
  int want = 0;
  ELX_RETURN_IF_ERROR(grid_size(kernel, smem, &want));
  if (grid != want) return cudaErrorInvalidValue;
  ELX_RETURN_IF_ERROR(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(grid), dim3(kThreads), args,
      smem, st));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_unit(SymvArgs<T> g, int grid, cudaStream_t st) {
  void* args[] = {&g};
  return launch(symv_kernel<T>, 0, args, grid, st);
}

template <typename T>
cudaError_t launch_tma(int n, const void* base, int c0, long long lda,
                       const void* v, void* y, void* ypart, int grid,
                       cudaStream_t st) {
  constexpr int elem = sizeof(T);
  if (reinterpret_cast<uintptr_t>(base) % 16 || (lda * elem) % 16 ||
      c0 < 0 || c0 * elem >= 16 || lda < c0 + n)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  ELX_RETURN_IF_ERROR(elx::tma::make_map(
      &map,
      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      elem, base, c0 + n, n, lda, elx::kSymvT, elx::kSymvT,
      CU_TENSOR_MAP_SWIZZLE_NONE));
  SymvTmaArgs<T> g{n, static_cast<const T*>(v), static_cast<T*>(y),
                   static_cast<T*>(ypart)};
  void* args[] = {&map, &c0, &g};
  return launch(symv_tma_kernel<T>, elx::SymvTiles<T>::kSmemBytes, args,
                grid, st);
}

}  // namespace

// Blocks of the cooperative launch of each core; the caller sizes ypart
// with it.
extern "C" int elx_symv_grid(int dtype, int* grid) {
  if (dtype == 0) return grid_size(symv_kernel<float>, 0, grid);
  if (dtype == 1) return grid_size(symv_kernel<double>, 0, grid);
  return cudaErrorInvalidValue;
}

extern "C" int elx_symv_tma_grid(int dtype, int* grid) {
  if (dtype == 0)
    return grid_size(symv_tma_kernel<float>,
                     elx::SymvTiles<float>::kSmemBytes, grid);
  if (dtype == 1)
    return grid_size(symv_tma_kernel<double>,
                     elx::SymvTiles<double>::kSmemBytes, grid);
  return cudaErrorInvalidValue;
}

// The "unit" core. dtype: 0 float, 1 double. a: n x n with row stride lda
// (unit column stride), lower triangle read; v, y: (n,); ypart: (grid, n)
// scratch.
extern "C" int elx_symv_lower(int dtype, int n, const void* a, long long lda,
                              const void* v, void* y, void* ypart, int grid,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || lda < n || grid <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (dtype == 0)
    return launch_unit<float>(
        SymvArgs<float>{static_cast<const float*>(a), lda, n,
                        static_cast<const float*>(v), static_cast<float*>(y),
                        static_cast<float*>(ypart)},
        grid, st);
  if (dtype == 1)
    return launch_unit<double>(
        SymvArgs<double>{static_cast<const double*>(a), lda, n,
                         static_cast<const double*>(v),
                         static_cast<double*>(y), static_cast<double*>(ypart)},
        grid, st);
  return cudaErrorInvalidValue;
}

// The "tma" core. A (n x n, unit column stride, lower triangle read)
// starts c0 elements after the 16-byte aligned address base, its rows lda
// elements apart (lda * the element size a multiple of 16 bytes); v, y:
// (n,); ypart: (grid, n) scratch, overwritten.
extern "C" int elx_symv_lower_tma(int dtype, int n, const void* base, int c0,
                                  long long lda, const void* v, void* y,
                                  void* ypart, int grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || grid <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (dtype == 0)
    return launch_tma<float>(n, base, c0, lda, v, y, ypart, grid, st);
  if (dtype == 1)
    return launch_tma<double>(n, base, c0, lda, v, y, ypart, grid, st);
  return cudaErrorInvalidValue;
}
